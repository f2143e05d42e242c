"""The TF32 switch of CUDA matmuls and cuDNN convolutions, set for the
length of a call and restored afterwards.

Exact fp32 needs TF32 off: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` (whose default is True). A call that
must score in exact fp32 (the encode at ``'highest'``, the quantizer's
surrogate scores, SSIM's windows) turns TF32 off only inside itself, so the
caller's own setting is never changed behind its back.
"""

from __future__ import annotations

import torch


class fp32_exact:
    """While active: TF32 off (enabled=True) or on (enabled=False) for CUDA
    matmuls and for cuDNN convolutions; enabled=None leaves both as they
    are. The previous settings come back on exit."""

    def __init__(self, enabled=True):
        self.enabled = enabled

    def __enter__(self):
        if self.enabled is not None:
            self._prev = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = not self.enabled
            torch.backends.cudnn.allow_tf32 = not self.enabled
        return self

    def __exit__(self, *exc):
        if self.enabled is not None:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self._prev
        return False
