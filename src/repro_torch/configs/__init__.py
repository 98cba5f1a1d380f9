"""Architecture registry of the port: the paper's own model
(``vq_opt_125m``) and every family of the reference's — dense attention,
recurrent (hymba, rwkv6) and MLA / MoE (deepseek-v2, deepseek-v3). Each
module has ``config()`` (full size, the reference's values) and
``smoke_config()`` (reduced, for CPU tests)."""
from __future__ import annotations

import importlib

# the reference's names (``repro/configs/__init__.py``) -> port modules
_ALIASES = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "gemma3-12b": "gemma3_12b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "internvl2-1b": "internvl2_1b",
    "musicgen-large": "musicgen_large",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "stablelm-1.6b": "stablelm_1_6b",
    "hymba-1.5b": "hymba_1_5b",
    "rwkv6-7b": "rwkv6_7b",
    "vq-opt-125m": "vq_opt_125m",
}


def get_config(name: str, smoke: bool = False, **kwargs):
    """``config()`` or ``smoke_config()`` of ``name`` (the reference's name
    or its module name); kwargs are forwarded (e.g. ``vqt=True``)."""
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in _ALIASES.values():
        raise ValueError(f"unknown architecture {name!r}; known: {all_arch_names()}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config(**kwargs) if smoke else mod.config(**kwargs)


def all_arch_names() -> list[str]:
    """The architectures the port serves (reference names)."""
    return list(_ALIASES)
