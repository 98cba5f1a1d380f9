"""The dense-attention model families (phi4-mini, stablelm, h2o-danube,
gemma3, internvl2, musicgen) in the port against ``repro.models.transformer``
on the reference's own smoke-config weights (PRNGKey(1)), both variants
(the published softmax model and ``vqt=True``): configs equal, the weights
carried across bit for bit, forward logits within 3e-4 with equal VQ codes,
decode steps within 3e-4 of the reference's, chunked prefill where the
family allows it, and the port's decode within 2e-3 of its own forward
(the reference's bound, ``tests/test_models.py:85-89``)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import arch_params  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import vq as ref_vq  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import vq as port_vq  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

ARCHS = ["phi4-mini-3.8b", "stablelm-1.6b", "h2o-danube-1.8b", "gemma3-12b",
         "internvl2-1b", "musicgen-large"]
CASES = [(a, v) for a in ARCHS for v in (False, True)]
ATOL = 3e-4


@functools.lru_cache(maxsize=None)
def _setup(arch, vqt):
    """(port cfg, reference cfg, reference params, port params)."""
    cfg_j, params, np_params = arch_params(arch, vqt)
    return (get_config(arch, smoke=True, vqt=vqt), cfg_j, params,
            PT.params_from_numpy(np_params, device="cpu"))


def _inputs(cfg, seed, b=2, n=24):
    """Seeded tokens ([b, n, cb] for audio), gapped positions and (VLM) 8
    patch embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (b, n, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, n)
    toks = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    pos = (np.arange(n)[None].repeat(b, 0) * 3).astype(np.int32)
    patches = (rng.standard_normal((b, 8, cfg.d_model)).astype(np.float32)
               if cfg.input_mode == "vlm" else None)
    return toks, pos, patches


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif hasattr(tree, "codebook") and not hasattr(tree, "shape"):  # VQParams
        yield path + ("codebook",), tree.codebook
    else:
        yield path, tree


def _fields(obj) -> dict:
    """A dataclass's fields by name (the two packages' classes differ)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("arch,vqt", CASES)
def test_config_fields_match_reference(arch, vqt):
    for smoke in (False, True):
        ours = get_config(arch, smoke=smoke, vqt=vqt)
        ref = ref_get_config(arch, smoke=smoke, vqt=vqt)
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(ref, f.name)
            if f.name == "vqt" and a is not None:
                a, b = _fields(a), _fields(b)
            if f.name == "stages":
                a, b = ([(tuple(map(_fields, pat)), r) for pat, r in st] for st in (a, b))
            assert a == b, (arch, smoke, f.name, a, b)
        # what the port leaves out is unset in these families
        assert (ref.moe, ref.mla, ref.ssm, ref.rwkv, ref.mtp) == (None, None, None, None, False)
        assert ours.resolved_head_dim == ref.resolved_head_dim


@pytest.mark.parametrize("arch,vqt", CASES)
def test_params_carry_across_bitwise(arch, vqt):
    """The reference's init turns into the port's tree with the same keys,
    shapes and bits; the port's own init has the reference's layout."""
    cfg, _, params, tp = _setup(arch, vqt)
    ref = list(_leaves(params))
    ported = list(_leaves(tp))
    assert [p for p, _ in ref] == [p for p, _ in ported]
    for (path, a), (_, t) in zip(ref, ported):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a), err_msg=str(path))
    own = list(_leaves(PT.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                      device="cpu")))
    assert [(p, tuple(t.shape)) for p, t in own] == [(p, tuple(a.shape)) for p, a in ref]
    assert isinstance(tp["stages"], list) and isinstance(tp["stages"][0], tuple)


def _recording(monkeypatch, mod):
    """Record the VQ codes of every ``quantize`` call of ``mod``."""
    codes = []
    quantize = mod.quantize

    def rec(p, x):
        x_q, idx = quantize(p, x)
        codes.append(np.asarray(idx))
        return x_q, idx

    monkeypatch.setattr(mod, "quantize", rec)
    return codes


@pytest.mark.parametrize("arch,vqt", CASES)
def test_forward_matches_reference(monkeypatch, arch, vqt):
    cfg, cfg_j, params, tp = _setup(arch, vqt)
    toks, pos, patches = _inputs(cfg, 0)
    kw_j = {} if patches is None else {"patch_embeds": jnp.asarray(patches)}
    kw_t = {} if patches is None else {"patch_embeds": torch.tensor(patches)}
    codes_j = _recording(monkeypatch, ref_vq)
    codes_t = _recording(monkeypatch, port_vq)
    want, aux_j = RT.forward(params, cfg_j, jnp.asarray(toks), jnp.asarray(pos), **kw_j)
    got, aux = PT.forward(tp, cfg, torch.tensor(toks), torch.tensor(pos), **kw_t)
    n_out = toks.shape[1] + (8 if patches is not None else 0)
    assert got.shape == want.shape and got.shape[:2] == (2, n_out)
    _close(got.numpy(), want)
    _close(aux["hidden"].numpy(), aux_j["hidden"])
    assert len(codes_t) == (cfg.n_layers if vqt else 0) == len(codes_j)
    for a, b in zip(codes_t, codes_j):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _ref_step(arch, vqt):
    cfg_j = _setup(arch, vqt)[1]
    return jax.jit(lambda p, c, t, pos: RT.decode_step(p, cfg_j, t, c, pos))


@pytest.mark.parametrize("arch,vqt", CASES)
def test_decode_matches_reference(arch, vqt):
    """``decode_step`` from ``init_caches`` against the reference's, step by
    step (ring caches included: the smoke window is 64)."""
    cfg, cfg_j, params, tp = _setup(arch, vqt)
    toks, pos, _ = _inputs(cfg, 1, n=5)
    cj = RT.init_caches(cfg_j, 2, 5, dtype=jnp.float32)
    ct = PT.init_caches(cfg, 2, 5, device="cpu")
    step = _ref_step(arch, vqt)
    for i in range(5):
        lj, cj = step(params, cj, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos[:, i:i + 1]))
        lt, ct = PT.decode_step(tp, cfg, torch.tensor(toks[:, i:i + 1]), ct,
                                torch.tensor(pos[:, i:i + 1]))
        assert lt.shape == lj.shape
        _close(lt.numpy(), lj)
    for sj, st in zip(cj, ct):
        for lj_, lt_ in zip(sj, st):
            _close(lt_["mix"]["k"].numpy(), lj_["mix"]["k"])
            np.testing.assert_array_equal(lt_["mix"]["len"].numpy(), np.asarray(lj_["mix"]["len"]))


@pytest.mark.parametrize("arch,vqt", CASES)
def test_decode_matches_own_forward(arch, vqt):
    """24 tokens through ``decode_step`` give the forward's last logits
    within 2e-3 (the reference's own contract; VLMs on their text, as the
    reference's test leaves them out)."""
    cfg, _, _, tp = _setup(arch, vqt)
    if cfg.input_mode == "vlm":
        cfg = dataclasses.replace(cfg, input_mode="tokens")
    toks, pos, _ = _inputs(cfg, 2)
    full, _ = PT.forward(tp, cfg, torch.tensor(toks), torch.tensor(pos))
    caches = PT.init_caches(cfg, 2, 24, device="cpu")
    for i in range(24):
        step, caches = PT.decode_step(tp, cfg, torch.tensor(toks[:, i:i + 1]), caches,
                                      torch.tensor(pos[:, i:i + 1]))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch,vqt", [c for c in CASES if c[0] in ("phi4-mini-3.8b",
                                                                    "stablelm-1.6b")])
def test_prefill_matches_reference(arch, vqt):
    """The chunkable families (plain tokens, no windows): a 20-token
    ``prefill_step`` and 4 decode steps against the reference's."""
    cfg, cfg_j, params, tp = _setup(arch, vqt)
    assert PT.chunkable(cfg) and RT.chunkable(cfg_j)
    toks, pos, _ = _inputs(cfg, 3)
    cj = RT.init_caches(cfg_j, 2, 24, dtype=jnp.float32)
    ct = PT.init_caches(cfg, 2, 24, device="cpu")
    prefill = jax.jit(lambda p, c, t, ps: RT.prefill_step(p, cfg_j, t, c, ps))
    lj, cj = prefill(params, cj, jnp.asarray(toks[:, :20]), jnp.asarray(pos[:, :20]))
    lt, ct = PT.prefill_step(tp, cfg, torch.tensor(toks[:, :20]), ct, torch.tensor(pos[:, :20]))
    _close(lt.numpy(), lj)
    step = _ref_step(arch, vqt)
    for i in range(20, 24):
        lj, cj = step(params, cj, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos[:, i:i + 1]))
        lt, ct = PT.decode_step(tp, cfg, torch.tensor(toks[:, i:i + 1]), ct,
                                torch.tensor(pos[:, i:i + 1]))
        _close(lt.numpy(), lj)


def test_unchunkable_families_refuse_prefill():
    for arch in ("h2o-danube-1.8b", "gemma3-12b", "internvl2-1b", "musicgen-large"):
        cfg = get_config(arch, smoke=True)
        assert not PT.chunkable(cfg) and not RT.chunkable(ref_get_config(arch, smoke=True))
        with pytest.raises(ValueError, match="chunked prefill"):
            PT.prefill_step({}, cfg, torch.zeros((1, 2), dtype=torch.int64), [], None)


def test_greedy_decode_matches_reference():
    """``serving/decode.greedy_decode`` is arch-neutral: musicgen's
    [b, n, cb] codebook tokens, token by token (not chunkable), give the
    reference's tokens."""
    from repro.serving.decode import greedy_decode as ref_greedy_decode
    from repro_torch.serving.decode import greedy_decode

    cfg, cfg_j, params, tp = _setup("musicgen-large", True)
    toks, pos, _ = _inputs(cfg, 4, n=6)
    want, _ = ref_greedy_decode(params, cfg_j, jnp.asarray(toks), 4, positions=jnp.asarray(pos))
    got, _ = greedy_decode(tp, cfg, torch.tensor(toks), 4, positions=torch.tensor(pos))
    assert got.shape == want.shape == (2, 4, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
