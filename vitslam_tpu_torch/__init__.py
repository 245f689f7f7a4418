"""vitslam_tpu_torch — the PyTorch + CUDA port of ``vitslam_tpu``.

The JAX package ``vitslam_tpu`` is the reference; this package mirrors its
layout (``geometry``, ``nn``, ``ops``, ``models``, ``slam``, ``io``,
``train``, ``eval``, ``config``, ``data``, ``viz``, ``cli``) and its public
names, so each module here has a counterpart of the same name there.
It imports ``torch`` and never ``jax`` or ``flax``.

Precision policy (as in the reference): fp32 parameters, bf16 compute in
the backbone and heads (cast at each matmul), fp32 pose and geometry, xyzw
quaternions, LayerNorm eps 1e-6.

Every Pallas kernel on a ported path has a hand-written CUDA kernel under
``csrc/`` (built with nvcc at first use, bound with ctypes); on CPU tensors
the wrappers run the kernel's plain PyTorch version instead.
"""
import torch

# fp32 matmuls and convs run in full fp32: cuDNN would otherwise run fp32
# convolutions in TF32 (about three decimal digits) by default, and the
# fp32 geometry and decode paths rely on full precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
