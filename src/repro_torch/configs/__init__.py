"""Architecture registry of the port. Only the paper's own model is ported
(``vq_opt_125m``); the reference's other architectures raise until their
model families land."""
from __future__ import annotations

from repro_torch.configs import vq_opt_125m

_ARCHS = {"vq-opt-125m": vq_opt_125m, "vq_opt_125m": vq_opt_125m}


def get_config(name: str, smoke: bool = False, **kwargs):
    """``config()`` or ``smoke_config()`` of ``name``; kwargs are forwarded
    (e.g. ``vqt=True``)."""
    mod = _ARCHS.get(name)
    if mod is None:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (the port serves "
            "vq-opt-125m; the other model families come with ROADMAP Queue A "
            "item 9)")
    return mod.smoke_config(**kwargs) if smoke else mod.config(**kwargs)


def all_arch_names() -> list[str]:
    return ["vq-opt-125m"]
