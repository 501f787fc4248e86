"""PocketFlow on PyTorch and CUDA: the port of ``pocketflow_tpu`` to an NVIDIA H100.

The package mirrors ``pocketflow_tpu``'s layout and public names (``config``,
``core``, ``ops``, ``nn``, ``nets``, ``datasets``, ``learners``) and is held
against it by the ``tests/test_torch_*.py`` parity tests.  It imports torch and
numpy, never jax.  Plain tensor code is PyTorch; each Pallas kernel of the JAX
package becomes a CUDA kernel for Hopper under ``csrc/``, built at first use.
"""

__version__ = '0.1.0'

from pocketflow_tpu_torch.config import FLAGS  # noqa: F401
