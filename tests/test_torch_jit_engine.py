"""The port's incremental engine against the reference's
``JitIncrementalEngine`` on the same weights and the same seeded mixed
replace / insert / delete buckets: codes equal, ``x[-1]`` within 3e-4,
overflow flags equal — on the fused path and on the inline path, ungated
and at ``delta_threshold`` 0 and 1."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.serving.jit_engine import JitIncrementalEngine as RefEngine  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.serving.jit_engine import (  # noqa: E402
    OP_DELETE, OP_INSERT, OP_REPLACE, JitIncrementalEngine, state_from_host,
    state_nbytes, state_nbytes_for, state_nbytes_for_config, state_to_host,
    weights_from_params,
)
from repro_torch.serving.batch_engine import (  # noqa: E402
    BatchedJitEngine, stack_states, unstack_state,
)

C, R = 4, 16


@pytest.fixture(scope="module")
def setup():
    cfg, params, np_params = smoke_params()
    weights = weights_from_params(np_params, port_smoke(), device="cpu")
    return cfg, params, weights


def _buckets(cfg, seed, n_steps=6, n=20, n_cap=32):
    """A seeded document plus a mixed stream of typed slot-level buckets
    (replace / insert into free slots at mid-gap ids / delete / mixed),
    with the host mirror that keeps every bucket valid."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros(n_cap, np.int32)
    tokens[:n] = rng.integers(0, cfg.vocab, n)
    valid = np.zeros(n_cap, bool)
    valid[:n] = True
    positions = np.full(n_cap, cfg.pos_pool - 1, np.int32)
    positions[:n] = np.arange(1, n + 1) * 16
    doc = (tokens.copy(), positions.copy(), valid.copy())
    steps = []
    for s in range(n_steps):
        kinds = [("replace", "insert", "delete", "mixed")[s % 4]] * C
        if kinds[0] == "mixed":
            kinds = list(rng.choice(["replace", "insert", "delete"], C))
        slot = np.full(C, -1, np.int32)
        tok = np.zeros(C, np.int32)
        pos = np.zeros(C, np.int32)
        op = np.zeros(C, np.int32)
        used = set()
        for i, kind in enumerate(kinds[: int(rng.integers(1, C + 1))]):
            live = [j for j in np.flatnonzero(valid) if j not in used]
            free = [j for j in np.flatnonzero(~valid) if j not in used]
            if kind == "insert" and free:
                j = int(free[0])
                taken = set(positions[valid]) | {int(pos[k]) for k in range(C)}
                pid = int(rng.integers(1, 16 * (n + 1)))
                while pid in taken:
                    pid += 1
                slot[i], tok[i], pos[i], op[i] = j, rng.integers(cfg.vocab), pid, OP_INSERT
                valid[j], positions[j] = True, pid
            elif kind == "delete" and len(live) > 2:
                j = int(rng.choice(live))
                slot[i], pos[i], op[i] = j, positions[j], OP_DELETE
                valid[j] = False
            elif live:
                j = int(rng.choice(live))
                slot[i], tok[i], op[i] = j, rng.integers(cfg.vocab), OP_REPLACE
            else:
                continue
            used.add(int(slot[i]))
        steps.append((slot, tok, pos, op))
    return doc, steps


def _assert_close(ref_state, state):
    for f in ("tokens", "positions", "valid", "n_real", "codes"):
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(ref_state, f)), err_msg=f)
    np.testing.assert_allclose(state.x[-1].numpy(), np.asarray(ref_state.x[-1]),
                               atol=3e-4)


def _run(engine, doc, steps, to_host):
    """full_forward, then each bucket; re-ingest after an overflow. Yields
    (state, overflow) after every step."""
    tokens, positions, valid = doc
    state = engine.full_forward(tokens, positions, valid)
    yield state, False
    for slot, tok, pos, op in steps:
        state, overflow = engine.apply_edits(state, slot, tok, pos, op)
        overflow = bool(overflow)
        yield state, overflow
        if overflow:
            state = engine.full_forward(*(to_host(a) for a in
                                          (state.tokens, state.positions, state.valid)))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_engine_matches_reference_mixed_stream(setup, fused, seed):
    cfg, params, weights = setup
    doc, steps = _buckets(cfg, seed)
    ref = RefEngine(params, cfg, edit_capacity=C, row_capacity=R,
                    use_fused_kernel=fused)
    ours = JitIncrementalEngine({}, port_smoke(), edit_capacity=C, row_capacity=R,
                                use_fused_kernel=fused, device="cpu",
                                _weights=weights)
    n_over = 0
    for (rs, ro), (ps, po) in zip(_run(ref, doc, steps, np.asarray),
                                  _run(ours, doc, steps, lambda t: t.numpy())):
        assert po == ro
        n_over += po
        _assert_close(rs, ps)
    assert n_over < len(steps)  # the stream mostly exercises the patch path


def test_threshold_zero_is_bitwise_ungated(setup):
    cfg, _, weights = setup
    doc, steps = _buckets(cfg, 2)
    mk = lambda **kw: JitIncrementalEngine({}, port_smoke(), edit_capacity=C,
                                           row_capacity=R, use_fused_kernel=True,
                                           device="cpu", _weights=weights, **kw)
    to_host = lambda t: t.numpy()
    for (a, oa), (b, ob) in zip(_run(mk(), doc, steps, to_host),
                                _run(mk(delta_threshold=0.0), doc, steps, to_host)):
        assert oa == ob
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError):
        mk(delta_threshold=-1.0)


@pytest.mark.parametrize("fused", [True, False])
def test_threshold_one_codes_match_reference(setup, fused):
    cfg, params, weights = setup
    doc, steps = _buckets(cfg, 3)
    ref = RefEngine(params, cfg, edit_capacity=C, row_capacity=R,
                    use_fused_kernel=fused, delta_threshold=1.0)
    ours = JitIncrementalEngine({}, port_smoke(), edit_capacity=C, row_capacity=R,
                                use_fused_kernel=fused, delta_threshold=1.0,
                                device="cpu", _weights=weights)
    for (rs, ro), (ps, po) in zip(_run(ref, doc, steps, np.asarray),
                                  _run(ours, doc, steps, lambda t: t.numpy())):
        assert po == ro
        _assert_close(rs, ps)


def test_batched_slice_equals_single_document(setup):
    """Slice b of one batched step equals the single-document step on
    document b — including an all-empty bucket (a dispatch's filler row)."""
    cfg, _, weights = setup
    kw = dict(edit_capacity=C, row_capacity=R, use_fused_kernel=True,
              device="cpu", _weights=weights)
    single = JitIncrementalEngine({}, port_smoke(), **kw)
    batched = BatchedJitEngine({}, port_smoke(), **kw)
    docs = [_buckets(cfg, s, n_steps=1) for s in (4, 5)]
    states = [single.full_forward(*d) for d, _ in docs]
    buckets = [st[0] for _, st in docs] + [
        (np.full(C, -1, np.int32),) + (np.zeros(C, np.int32),) * 3]
    bstate = stack_states(states + [states[0]])
    new_b, over_b = batched.batch_apply_edits(
        bstate, *(np.stack([bk[i] for bk in buckets]) for i in range(4)))
    for b, state in enumerate(states + [states[0]]):
        new_s, over_s = single.apply_edits(state, *buckets[b])
        assert bool(over_b[b]) == bool(over_s)
        got = unstack_state(new_b, b)
        for f in got._fields:
            torch.testing.assert_close(getattr(got, f), getattr(new_s, f),
                                       atol=1e-5, rtol=1e-5)
    filler = unstack_state(new_b, 2)
    assert torch.equal(filler.codes, states[0].codes)
    assert torch.equal(filler.x, states[0].x)
    logits = batched.batch_logits_at(new_b, [19, 7, 0])
    for b, slot in enumerate((19, 7, 0)):
        torch.testing.assert_close(
            logits[b], single.logits_at(unstack_state(new_b, b), slot))


def test_state_surgery_and_host_round_trip(setup):
    """pad_state appends free zero slots and keeps every existing bit;
    gather_slots permutes the slot axis; the host snapshot re-uploads
    bit-exactly; the byte formulas match a real state."""
    cfg, _, weights = setup
    eng = JitIncrementalEngine({}, port_smoke(), edit_capacity=C, row_capacity=R,
                               device="cpu", _weights=weights)
    (doc, _), n_cap = _buckets(cfg, 6, n_steps=0), 32
    state = eng.full_forward(*doc)
    padded = eng.pad_state(state, 64, pos_fill=cfg.pos_pool - 1)
    for f in state._fields:
        a, b = getattr(state, f), getattr(padded, f)
        axis = 0 if a.dim() == 1 else 1
        if a.dim() == 0:
            assert torch.equal(a, b)
            continue
        assert torch.equal(b.narrow(axis, 0, n_cap), a), f
        tail = b.narrow(axis, n_cap, 64 - n_cap)
        assert (tail == (cfg.pos_pool - 1 if f == "positions" else 0)).all(), f
    order = np.random.default_rng(0).permutation(n_cap)
    perm = eng.gather_slots(state, order)
    assert torch.equal(perm.x[:, 3], state.x[:, order[3]])
    assert torch.equal(perm.tokens, state.tokens[torch.from_numpy(order)])
    back = state_from_host(state_to_host(state), "cpu")
    for a, b in zip(state, back):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert state_nbytes(state) == state_nbytes_for(n_cap, eng.L, eng.meta) \
        == state_nbytes_for_config(port_smoke(), n_cap)


def test_typed_wrappers_equal_generic_step(setup):
    """apply_replaces / apply_inserts / apply_deletes (and their batched
    forms) are the generic step with the op vector filled in."""
    cfg, _, weights = setup
    kw = dict(edit_capacity=C, row_capacity=R, use_fused_kernel=True,
              device="cpu", _weights=weights)
    eng = JitIncrementalEngine({}, port_smoke(), **kw)
    beng = BatchedJitEngine({}, port_smoke(), **kw)
    doc, _ = _buckets(cfg, 7, n_steps=0)
    state = eng.full_forward(*doc)
    slot = np.array([2, 21, -1, -1], np.int32)  # 21 is a free slot
    tok = np.array([5, 6, 0, 0], np.int32)
    pos = np.array([0, 250, 0, 0], np.int32)
    op_of = lambda code: np.where(slot >= 0, code, 0).astype(np.int32)
    cases = [
        (eng.apply_replaces(state, np.array([2, 3, -1, -1]), tok),
         eng.apply_edits(state, [2, 3, -1, -1], tok, np.zeros(C), np.zeros(C))),
        (eng.apply_inserts(state, [21, 22, -1, -1], tok, [250, 260, 0, 0]),
         eng.apply_edits(state, [21, 22, -1, -1], tok, [250, 260, 0, 0],
                         op_of(OP_INSERT))),
        (eng.apply_deletes(state, slot[:1].tolist() + [-1] * 3),
         eng.apply_edits(state, [2, -1, -1, -1], np.zeros(C), pos,
                         [OP_DELETE, 0, 0, 0])),
    ]
    for (a, oa), (b, ob) in cases:
        assert bool(oa) == bool(ob)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    bstate = stack_states([state])
    for (a, _), (b, _) in [
        (beng.batch_apply_replaces(bstate, slot[None], tok[None]),
         beng.batch_apply_edits(bstate, slot[None], tok[None], np.zeros((1, C)),
                                np.zeros((1, C)))),
        (beng.batch_apply_deletes(bstate, np.array([[2, 3, -1, -1]])),
         beng.batch_apply_edits(bstate, np.array([[2, 3, -1, -1]]),
                                np.zeros((1, C)), np.zeros((1, C)),
                                np.array([[OP_DELETE, OP_DELETE, 0, 0]]))),
    ]:
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
