"""MoleculeSDE in PyTorch for NVIDIA Hopper (H100).

The port of the JAX package ``moleculesde_tpu`` (which stays the numerical
reference).  Plain tensor code is PyTorch; every Pallas kernel of the JAX
package on a ported path becomes a CUDA C++ kernel for ``sm_90a``
(``csrc/``), built with ``nvcc`` on first use (``kernels/build.py``) and
bound through ``ctypes``.  Each kernel wrapper keeps a plain PyTorch
version of the same function beside it, which tensors on the CPU take.

Ported so far: 2D->3D conformer generation and 3D->2D graph generation
(the encoders, both score models, both predictor-corrector samplers and
their CLIs), joint pretraining as the JAX package's CLI runs it
(``pretrain/``, ``examples/pretrain.py``: both ingests, size buckets,
microbatching, full-state resume), the three finetunes, and the
datasets they read: QM9, MoleculeNet, MD17 and PCQM4Mv2, the last as a
memory-mapped packed cache in the JAX package's format
(``data/packed.py``).  ``utils/checkpoints.py`` reads the JAX package's
``.msgpack`` checkpoints without JAX.  ``parallel/`` runs all of it data
parallel, one process a device (``--num_devices``, ``--distributed``).
"""

__version__ = "0.1.0"
