"""xivo_tpu_torch — the PyTorch/CUDA port of ``xivo_tpu``.

The JAX package ``xivo_tpu`` stays the reference; this package mirrors its
layout (``filter/``, ``frontend/``, ``geom/``, ``cam/``, ``ops/``,
``sim/``, ``runner.py``) so each module's counterpart is easy to find. It
imports ``torch`` and never ``jax`` or anything of ``xivo_tpu``.

Conventions: every filter function takes tensors with a leading batch
axis B (the JAX package's ``vmap`` written out); state is NamedTuples of
tensors; index tensors are int64. Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
import torch

# The covariance algebra needs true float32 products (the reference forces
# float32 matmul precision for the same reason): TF32 stays off, for
# matmuls and for cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "xivo_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run on the CPU")
    return dev
