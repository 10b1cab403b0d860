"""repro_torch: the Eventor EMVS datapath in PyTorch, with hand-written
CUDA kernels for the NVIDIA H100.

The JAX package `repro` is the reference; this package mirrors its module
paths and public names and imports nothing from it. Entry points run on the
CUDA card unless the caller passes `device="cpu"`.

Float32 matrix products and convolutions on the card run in full float32
(TF32 off), so the plain versions hold the kernels to the reference's
arithmetic.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
