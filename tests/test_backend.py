"""The one backend choice: which profile-DP implementation runs."""

import jax
import pytest

from sina_tpu import backend


@pytest.mark.parametrize(
    "platform, impl",
    [("gpu", "cuda"), ("cpu", "xla"), ("metal", None), ("rocm", None)],
)
def test_dp_backend_by_platform(monkeypatch, platform, impl):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if impl is None:
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            backend.dp_backend()
    else:
        assert backend.dp_backend() == impl


def test_default_device_context_wins(monkeypatch):
    """Work placed on the CPU inside jax.default_device runs the XLA
    path even in a process whose default backend is the GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.dp_backend() == "cuda"
    with jax.default_device(jax.devices("cpu")[0]):
        assert backend.dp_backend() == "xla"
