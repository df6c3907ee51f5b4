"""dvs_of_training_framework_tpu_torch — the PyTorch and CUDA port of
``dvs_of_training_framework_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``data/``, ``ops/``, ``models/``, ``losses/``, ``training/``, ``utils/``)
so each module's counterpart is found under the same name.  It imports
PyTorch and never JAX.  The kernels that the JAX package wrote in Pallas
for the TPU are CUDA C++ here (``csrc/``), built with nvcc on first use;
each keeps a plain PyTorch twin that CPU tensors take.
"""

__version__ = '0.1.0'
