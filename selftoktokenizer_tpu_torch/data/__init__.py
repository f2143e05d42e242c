"""Image ingestion: the C++ loader (``csrc/dataloader.cc``) and the tar
shard stream over it (``data/native.py``)."""
