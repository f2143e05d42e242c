"""Reconstruction-quality networks: Inception-V3 pool3 features for rFID
(``eval/inception.py``) and the LPIPS-VGG16 distance (``eval/lpips.py``)."""
