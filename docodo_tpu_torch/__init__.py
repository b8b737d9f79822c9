"""docodo_tpu_torch: the device half of docodo_tpu on PyTorch and CUDA.

The JAX package (docodo_tpu) is the reference this port is held against.
The host layers (index build, parsing, sources) are shared with it and
import no jax; this package replaces its `ops/` on torch, with the TPU
kernels of the full-result query path as CUDA kernels for Hopper
(csrc/locate_full.cu). It imports torch and never jax.

  ops/seqops.py        posting algebra on batched tensors
  ops/device_index.py  the device index and full-result query routing
  ops/query_kernels.py the kernel wrappers and their plain versions
  ops/_cuda.py         nvcc build at first use + ctypes binding
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy exports, as in docodo_tpu/__init__.py
    if name == "DeviceIndex":
        from docodo_tpu_torch.ops.device_index import DeviceIndex

        return DeviceIndex
    raise AttributeError(name)
