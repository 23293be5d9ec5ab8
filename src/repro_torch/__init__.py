"""PyTorch/CUDA port of the LAMP serving stack, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``configs``, ``kernels``, ``models``, ``serving``, ``launch``) and
imports nothing of it. Plain tensor code is PyTorch; the paged LAMP
attention kernel is hand-written CUDA (``kernels/csrc``).

TF32 is switched off here, where the package is first imported: the LAMP
recompute arm is the FP32 reference, and a TF32 matmul or convolution
would leave it with about 10 mantissa bits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
