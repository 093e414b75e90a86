"""Which devices the work goes to, and which implementation runs there."""

from __future__ import annotations


def _platform() -> str:
    """The platform of the device `jax.default_device` selects, else
    JAX's default backend."""
    import jax

    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def local_devices() -> list:
    """This process's devices on the platform work is placed on (all
    local GPUs in a GPU process; the CPU inside
    `jax.default_device(cpu)`)."""
    import jax

    return jax.local_devices(backend=_platform())


def dp_backend() -> str:
    """The profile chain DP's implementation for the device that work
    is placed on: "cuda" (the CUDA kernel, ops/cuda/chain_dp.cu) on an
    NVIDIA GPU, "xla" (the plain lax path) on the CPU.  Any other
    platform is an error: nothing here was built or checked for it."""
    platform = _platform()
    if platform == "gpu":
        return "cuda"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(
        f"unsupported JAX platform {platform!r}: sina_tpu runs on an "
        "NVIDIA GPU ('gpu') or the CPU ('cpu')"
    )
