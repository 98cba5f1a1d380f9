"""``repro_torch.launch.{roofline,hlo_stats,specs}`` against the JAX
package's: the analytic edit-step roofline (equal numbers at the
reference's peaks, the port's own defaults the H100's), the HLO text
parsers (the strings of ``tests/test_launch.py`` and a compiled reference
function), and the input stand-ins (equal shapes for every registry arch
and input shape; the dtype mapping below)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_arch_names  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import hlo_stats as ref_hlo  # noqa: E402
from repro.launch import roofline as ref_roof  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import hlo_stats, roofline, specs  # noqa: E402

# the reference's dtype -> the port's: tokens and positions stay int32;
# patch embeddings are f32, the dtype the port's forward runs in
DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.float32}

VQOPT = dict(d=768, H=12, dh=64, Q=64, hq=2)
SMOKE = dict(d=256, H=4, dh=64, Q=16, hq=2)
# (layers, meta, n_cap, C, R, d_ff, batch, weight bytes)
ROOFLINE_CASES = [
    (12, VQOPT, 1024, 8, 32, 3072, 1, 0),
    (12, VQOPT, 1024, 1032, 32, 3072, 1, 498_000_000),
    (12, VQOPT, 1024, 264, 64, 3072, 2, 498_000_000),
    (12, VQOPT, 4096, 72, 32, 0, 4, 123_456_789),
    (2, SMOKE, 64, 8, 8, 1024, 8, 4_000_000),
    (2, SMOKE, 128, 16, 16, 0, 1, 0),
]


@pytest.mark.parametrize("L,meta,n_cap,C,R,d_ff,batch,wbytes", ROOFLINE_CASES)
def test_roofline_numbers_equal_the_reference(L, meta, n_cap, C, R, d_ff, batch, wbytes):
    assert roofline.edit_step_flops(L, meta, n_cap, C, R, d_ff) == pytest.approx(
        ref_roof.edit_step_flops(L, meta, n_cap, C, R, d_ff), rel=1e-12)
    assert roofline.edit_step_bytes(L, meta, n_cap, wbytes) == pytest.approx(
        ref_roof.edit_step_bytes(L, meta, n_cap, wbytes), rel=1e-12)
    kw = dict(xla_flops=3.0e12, xla_bytes=7.0e9, weight_bytes=wbytes, batch=batch, d_ff=d_ff)
    want = ref_roof.edit_step_roofline(L, meta, n_cap, C, R, **kw)
    got = dataclasses.replace(roofline.edit_step_roofline(L, meta, n_cap, C, R, **kw),
                              peak_flops=ref_roof.PEAK_FLOPS, hbm_bw=ref_roof.HBM_BW)
    for name in ("compute_s", "memory_s", "useful_flop_fraction", "useful_byte_fraction"):
        assert getattr(got, name) == pytest.approx(getattr(want, name), rel=1e-12), name
    assert got.summary() == pytest.approx(want.summary(), rel=1e-12)
    assert got.bottleneck == want.bottleneck


def test_roofline_defaults_are_the_h100s():
    """The port prices at the H100's FP32 and HBM peaks, never the
    reference's TPU ones."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (67e12, 3.35e12)
    r = roofline.edit_step_roofline(12, VQOPT, 1024, 72, 32, xla_flops=0, xla_bytes=0)
    assert (r.peak_flops, r.hbm_bw) == (67e12, 3.35e12)
    assert r.useful_flop_fraction == 0.0


@pytest.mark.parametrize("type_str", ["f32[2,3]", "bf16[4,4]{1,0}", "(f32[2], s32[3])",
                                      "pred[]", "u8[7,0]", "c64[3]", "f8e4m3fn[16]"])
def test_shape_bytes_equal_the_reference(type_str):
    assert hlo_stats._shape_bytes(type_str) == ref_hlo._shape_bytes(type_str)


SYNTHETIC = """
HloModule m
  %p0 = f32[8,16]{1,0} parameter(0)
  %ar = f32[8,16]{1,0} all-reduce(%p0), replica_groups={}
  %ag.1 = f32[16,16]{1,0} all-gather(%ar), dimensions={0}
  %x = f32[8,16]{1,0} add(%p0, %ar)
"""


def _compiled_reference_hlo() -> str:
    def f(x, w):
        def body(i, acc):
            return jnp.tanh(acc @ w) + i

        return jax.lax.fori_loop(0, 5, body, x).sum()

    x = jnp.ones((8, 16), jnp.float32)
    return jax.jit(f).lower(x, jnp.eye(16)).compile().as_text()


@pytest.mark.parametrize("which", ["synthetic", "compiled"])
def test_hlo_parsers_equal_the_reference(which):
    text = SYNTHETIC if which == "synthetic" else _compiled_reference_hlo()
    got, want = hlo_stats.collective_stats(text), ref_hlo.collective_stats(text)
    assert got.summary() == want.summary() and got.total_bytes == want.total_bytes
    assert hlo_stats.top_ops_by_bytes(text, 25) == ref_hlo.top_ops_by_bytes(text, 25)
    assert hlo_stats.launch_stats(text).summary() == ref_hlo.launch_stats(text).summary()
    assert hlo_stats.while_trip_counts(text) == ref_hlo.while_trip_counts(text)
    if which == "synthetic":  # the reference's own contract (tests/test_launch.py)
        assert got.bytes_by_kind["all-reduce"] == 8 * 16 * 4
        assert got.bytes_by_kind["all-gather"] == 8 * 16 * 4
    else:
        assert hlo_stats.launch_stats(text).instructions > 0


@pytest.mark.parametrize("arch", all_arch_names())
@pytest.mark.parametrize("shape", list(ref_specs.SHAPES))
def test_input_specs_equal_the_reference(arch, shape):
    cfg, cfg_j = get_config(arch), ref_get_config(arch)
    sc, sc_j = specs.SHAPES[shape], ref_specs.SHAPES[shape]
    assert (sc.name, sc.kind, sc.seq_len, sc.global_batch) == (
        sc_j.name, sc_j.kind, sc_j.seq_len, sc_j.global_batch)
    fn = "decode_token_specs" if sc.kind == "decode" else "input_specs"
    got, want = getattr(specs, fn)(cfg, sc), getattr(ref_specs, fn)(cfg_j, sc_j)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == DTYPES[jnp.dtype(want[k].dtype)], k
        assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch", all_arch_names())
def test_shape_supported_equals_the_reference(arch):
    assert specs.LONG_CONTEXT_OK == ref_specs.LONG_CONTEXT_OK
    for name in specs.SHAPES:
        assert (specs.shape_supported(get_config(arch), specs.SHAPES[name])
                == ref_specs.shape_supported(ref_get_config(arch), ref_specs.SHAPES[name]))
