"""The port's per-module inits (``attn_init``, ``ffn_init``,
``embedding_init``, ``rmsnorm_init``, ``layernorm_init``) against the
reference's at the smoke configs: the same tree of keys, shapes and
dtypes. The draws differ (``jax.random`` against a ``torch.Generator``);
``init_params`` draws through these inits in its own fixed order."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import params_to_numpy  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.vq_opt_125m import smoke_config as ref_smoke  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import embedding as ref_embed  # noqa: E402
from repro.models import ffn as ref_ffn  # noqa: E402
from repro.models import norms as ref_norms  # noqa: E402
from repro_torch.configs import all_arch_names, get_config  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config  # noqa: E402
from repro_torch.models import attention, embedding, ffn, norms  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402

KEY = jax.random.PRNGKey(3)


def gen():
    return torch.Generator().manual_seed(3)


def layout(tree, path=""):
    """{path: (shape, dtype name)} of a numpy or torch tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in layout(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}
    return {path: (tuple(tree.shape), str(tree.dtype))}


def ref_layout(tree):
    return layout(params_to_numpy(jax.device_get(tree)))


def configs(vqt):
    """(reference, port) smoke configs: VQ-OPT and every registry arch."""
    out = [(ref_smoke(vqt=vqt), smoke_config(vqt=vqt))]
    return out + [(ref_config(a, smoke=True, vqt=vqt), get_config(a, smoke=True, vqt=vqt))
                  for a in all_arch_names()]


@pytest.mark.parametrize("vqt", [False, True])
def test_attn_init_layout_equals_reference(vqt):
    seen = 0
    for rcfg, pcfg in configs(vqt):
        for (rpat, _), (ppat, _) in zip(rcfg.stages, pcfg.stages):
            for rl, pl in zip(rpat, ppat):
                if rl.mixer != "gqa":
                    continue
                want = ref_layout(ref_attn.attn_init(KEY, rcfg, rl))
                assert layout(attention.attn_init(gen(), pcfg, pl)) == want, rcfg.name
                seen += 1
    assert seen >= 8  # VQ-OPT, the dense families, biases and GQA among them


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu", "relu2"])
def test_ffn_init_layout_equals_reference(kind):
    want = ref_layout(ref_ffn.ffn_init(KEY, kind, 48, 96))
    assert layout(ffn.ffn_init(gen(), kind, 48, 96)) == want
    stacked = layout(ffn.ffn_init(gen(), kind, 48, 96, (3,)))
    assert stacked == {k: ((3,) + s, d) for k, (s, d) in want.items()}
    with pytest.raises(ValueError):
        ffn.ffn_init(gen(), "moe", 48, 96)


@pytest.mark.parametrize("vqt", [False, True])
def test_embedding_init_layout_equals_reference(vqt):
    for rcfg, pcfg in configs(vqt):
        want = ref_layout(ref_embed.embedding_init(KEY, rcfg))
        assert layout(embedding.embedding_init(gen(), pcfg)) == want, (rcfg.name, rcfg.pos)


def test_norm_inits_equal_reference():
    for ref_init, port_init in ((ref_norms.rmsnorm_init, norms.rmsnorm_init),
                                (ref_norms.layernorm_init, norms.layernorm_init)):
        want = params_to_numpy(jax.device_get(ref_init(48)))
        got = port_init(48)
        assert layout(got) == layout(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert layout(norms.layernorm_init(48, (2,))) == {"/scale": ((2, 48), "float32"),
                                                      "/bias": ((2, 48), "float32")}


def test_init_params_draws_the_embedding_first():
    """``init_params`` draws the embedding first, through ``embedding_init``,
    so the same seed gives the same table both ways."""
    cfg = smoke_config(vqt=True)
    params = init_params(cfg, generator=gen(), device="cpu")
    embed = embedding.embedding_init(gen(), cfg)
    assert params["embed"].keys() == embed.keys()
    for k in embed:
        assert torch.equal(params["embed"][k], embed[k])
