"""MoleculeSDE in PyTorch for NVIDIA Hopper (H100).

The port of the JAX package ``moleculesde_tpu`` (which stays the numerical
reference).  Plain tensor code is PyTorch; every Pallas kernel of the JAX
package on a ported path becomes a CUDA C++ kernel for ``sm_90a``
(``csrc/``), built with ``nvcc`` on first use (``kernels/build.py``) and
bound through ``ctypes``.  Each kernel wrapper keeps a plain PyTorch
version of the same function beside it, which tensors on the CPU take.

Ported so far: 2D->3D conformer generation (GIN encoder, the 2D->3D score
model's channel-major sampling path, the predictor-corrector sampler) and
one step of joint pretraining (GIN and SchNet, the dual contrastive loss,
both score-matching losses, Adam; ``pretrain/``, ``examples/pretrain.py``).
"""

__version__ = "0.1.0"
