"""The port's GSPN-2 language model against the JAX reference package: the
sequence mixer (one-shot, with its cache, and chunked prefill), the O(W)
decode step, the LM's forward, prefill, chunked prefill and decode, from
the same numpy inputs and parameters carried across by
``lm_state_from_jax``; and the port's own invariants (a chunk chain equals
one-shot prefill, prefill then decode equals the forward, the chunk
contract raises, the ``chunk_resume`` label changes no number).

Tolerances: under ``with_precision(cfg, "f32")`` 1e-5 of the largest
magnitude for mixer outputs and caches and 1e-4 for logits; under the
config's own policy (bf16 compute) 1e-2 in relative L2, the bound of
DESIGN.md §10.  All on the ``reduced()`` config (2 layers, d 48, vocab
512, row width 8) or smaller, on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import qwen2_1_5b_gspn as jq
from repro.core import gspn as jgspn
from repro.kernels import spec as jspec
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import base as tbase
from repro_torch.configs import qwen2_1_5b_gspn as tq
from repro_torch.core import gspn
from repro_torch.kernels import cuda_lib, spec
from repro_torch.models import layers
from repro_torch.models import lm
from repro_torch.models.convert import lm_state_from_jax

TOL = 1e-5
LOGITS_TOL = 1e-4
BF16_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps torch from competing with
    the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol=TOL, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _tree_close(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for key in want:
        assert sorted(got[key]) == sorted(want[key]), key
        for name in want[key]:
            _close(got[key][name], want[key][name], tol, f"{key}/{name}")


# ---------------------------------------------------------------------------
# The sequence mixer.
# ---------------------------------------------------------------------------

B, CP, DIM = 2, 4, 12


def _mixer(row_width=8, seed=0, **kw):
    """The reference's mixer parameters and the port's mixer holding
    them."""
    jcfg = jgspn.GSPNSeqConfig(dim=DIM, proxy_dim=CP, row_width=row_width,
                               impl="xla", **kw)
    params = jgspn.init_gspn_seq_mixer(jax.random.PRNGKey(seed), jcfg)
    tkw = {k: getattr(torch, str(jnp.dtype(v))) for k, v in kw.items()}
    mixer = gspn.GSPNSeqMixer(
        gspn.GSPNSeqConfig(dim=DIM, proxy_dim=CP, row_width=row_width,
                           **tkw), device="meta")
    mixer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           params.items()}, assign=True)
    return jcfg, params, mixer


def _x(seed, length, dim=DIM, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, length, dim)).astype(np.float32)


def _zero_cache(w, batch=B):
    return {"prev_row": torch.zeros((batch, CP, w)),
            "cur_row": torch.zeros((batch, CP, w)),
            "row_state": torch.zeros((batch, CP)),
            "pos": torch.zeros((batch,), dtype=torch.int32)}


@pytest.mark.parametrize("row_width,length", [(8, 21), (8, 24), (0, 30)])
def test_mixer_one_shot_matches_jax(row_width, length):
    jcfg, params, mixer = _mixer(row_width)
    x = _x(1, length)
    want = jgspn.apply_gspn_seq_mixer(params, jnp.asarray(x), jcfg)
    _close(mixer(torch.from_numpy(x)), want)
    want_y, want_cache = jgspn.apply_gspn_seq_mixer(
        params, jnp.asarray(x), jcfg, return_cache=True)
    got_y, got_cache = mixer(torch.from_numpy(x), return_cache=True)
    _close(got_y, want_y)
    assert got_cache["pos"].dtype == torch.int32
    assert sorted(got_cache) == sorted(want_cache)
    for name in want_cache:
        _close(got_cache[name], want_cache[name], what=name)


def _chain_port(mixer, x, chunks):
    cache = _zero_cache(mixer.cfg.row_width)
    ys, lo = [], 0
    for t in chunks:
        y, cache = gspn.gspn_seq_prefill_chunk(
            mixer, torch.from_numpy(x[:, lo:lo + t]), cache)
        ys.append(y)
        lo += t
    return torch.cat(ys, dim=1), cache


# Admissible chunkings (every chunk but the last covers whole rows of 8).
CHUNKINGS = {
    "head_single_row_ragged_tail": [8, 24, 19],
    "uneven_rows_tiny_tail": [16, 8, 8, 5],
    "single_partial_row": [3],
    "tail_on_row_boundary": [8, 16],
    "every_row_its_own_chunk": [8] * 4 + [1],
}


@pytest.mark.parametrize("name", sorted(CHUNKINGS))
def test_prefill_chunk_chain_matches_jax_and_one_shot(name):
    """Each chunk of the chain against the reference's
    ``gspn_seq_prefill_chunk``, and the chain against one-shot prefill
    (the port's own invariant), output and outgoing cache."""
    chunks = CHUNKINGS[name]
    jcfg, params, mixer = _mixer(seed=3)
    x = _x(len(name), sum(chunks))
    got, cache = _chain_port(mixer, x, chunks)

    jcache = {k: jnp.asarray(v.numpy()) for k, v in
              _zero_cache(8).items()}
    ys, lo = [], 0
    for t in chunks:
        y, jcache = jgspn.gspn_seq_prefill_chunk(
            params, jnp.asarray(x[:, lo:lo + t]), jcfg, jcache)
        ys.append(y)
        lo += t
    _close(got, jnp.concatenate(ys, axis=1))
    for leg in ("prev_row", "cur_row", "row_state", "pos"):
        _close(cache[leg], jcache[leg], what=leg)

    ref, ref_cache = mixer(torch.from_numpy(x), return_cache=True)
    _close(got, ref)
    for leg in ("prev_row", "cur_row", "row_state", "pos"):
        _close(cache[leg], ref_cache[leg], what=leg)


def test_prefill_chunk_contract_raises():
    _, _, mixer = _mixer()
    cache = _zero_cache(8)
    cache["pos"] = torch.tensor([8, 5], dtype=torch.int32)
    x = torch.from_numpy(_x(2, 4))
    with pytest.raises(ValueError, match="grid-row boundary"):
        gspn.gspn_seq_prefill_chunk(mixer, x, cache)
    with pytest.raises(ValueError, match="grid-row boundary"):
        gspn.gspn_seq_prefill_chunk(mixer, x, _zero_cache(8), pos=12)
    _, _, free_fold = _mixer(row_width=0)
    with pytest.raises(ValueError, match="fixed row_width"):
        gspn.gspn_seq_prefill_chunk(free_fold, x, _zero_cache(8))


def test_chunk_resume_label_is_numerically_inert(monkeypatch):
    """The chain's launches carry ``chunk_resume``; forcing ``one_shot``
    in its place moves no bit of the output or the cache."""
    _, _, mixer = _mixer(seed=5)
    assert mixer.resume_spec.boundary == "chunk_resume"
    assert mixer.resume_spec.canonical() != mixer.spec.canonical()
    x = _x(6, 29)
    got, cache = _chain_port(mixer, x, [16, 13])
    monkeypatch.setattr(mixer, "resume_spec", mixer.spec)
    want, want_cache = _chain_port(mixer, x, [16, 13])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for leg in cache:
        torch.testing.assert_close(cache[leg], want_cache[leg], rtol=0,
                                   atol=0)


def test_spec_grid_with_chunk_resume_is_the_reference_grid_mapped():
    legs = {"pallas": "cuda", "multidir": "cuda", "xla": "torch"}
    both = ("one_shot", "chunk_resume")
    theirs = {(s.direction, legs[s.impl], s.channels_per_weight,
               s.stream_dtype, s.boundary)
              for s in jspec.enumerate_specs(boundaries=both)
              if s.carry_dtype == "float32"}
    mine = [(s.direction, s.impl, s.channels_per_weight, s.stream_dtype,
             s.boundary) for s in spec.enumerate_specs(boundaries=both)]
    assert len(mine) == len(set(mine)) and set(mine) == theirs
    s = spec.ScanSpec(impl="cuda", boundary="chunk_resume")
    assert s.canonical() == jspec.ScanSpec(
        impl="pallas", boundary="chunk_resume").canonical().replace(
            "|pallas|", "|cuda|")
    with pytest.raises(ValueError):
        spec.ScanSpec(boundary="sp_block_local")


# ---------------------------------------------------------------------------
# The decode step.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_decode_step_matches_jax(state_dtype):
    """Eleven steps from a prefill of 13 tokens (row width 8): the steps
    cross a row end (column 7) and a row start (column 0), with the two
    sequences of the batch at different positions; the cache at rest in
    ``state_dtype``."""
    jcfg, params, mixer = _mixer(seed=9)
    x = _x(10, 13)
    _, cache = mixer(torch.from_numpy(x), return_cache=True)
    cache["pos"] = torch.tensor([13, 6], dtype=torch.int32)
    cache = {k: v.to(state_dtype) if v.is_floating_point() else v
             for k, v in cache.items()}
    jdt = jnp.bfloat16 if state_dtype == torch.bfloat16 else jnp.float32
    jcache = {k: jnp.asarray(_np(v)).astype(jdt) if v.is_floating_point()
              else jnp.asarray(v.numpy()) for k, v in cache.items()}
    steps = _x(11, 11)
    for i in range(steps.shape[1]):
        tok = steps[:, i:i + 1]
        y, cache = lm.gspn_decode_step(mixer, torch.from_numpy(tok), cache)
        jy, jcache = jlm.gspn_decode_step(params, jnp.asarray(tok), jcfg,
                                          jcache)
        _close(y, jy, what=f"step {i}")
        for leg in ("prev_row", "cur_row", "row_state", "pos"):
            _close(cache[leg], jcache[leg], what=f"step {i} {leg}")


# ---------------------------------------------------------------------------
# Layers and configs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_and_swiglu_match_jax(dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    norm = layers.RMSNorm(16, device="cpu")
    norm.scale.data = torch.from_numpy(scale)
    want = jlayers.apply_rmsnorm({"scale": jnp.asarray(scale)},
                                 jnp.asarray(x).astype(jdt))
    got = norm(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    if dtype == torch.float32:
        _close(got, want)
    else:
        assert _rel_l2(got, want) <= BF16_TOL

    p = jlayers.init_swiglu(jax.random.PRNGKey(1), 16, 40)
    policy = layers.DTypePolicy(compute_dtype=dtype)
    ffn = layers.SwiGLU(16, 40, policy, generator=None, device="meta")
    ffn.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()}, assign=True)
    want = jlayers.apply_swiglu(p, jnp.asarray(x).astype(jdt),
                                jlayers.DTypePolicy(compute_dtype=jdt))
    got = ffn(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    if dtype == torch.float32:
        _close(got, want)
    else:
        assert _rel_l2(got, want) <= BF16_TOL


def test_inits_match_the_reference_distributions():
    """Truncated normals at 1/sqrt(d_in) and 0.02, and the mixer's
    uniform(±1/sqrt(d_in)): the same bounds and spread as the
    reference's initialisers."""
    cfg = dataclasses.replace(tq.reduced(), d_model=256, vocab=4096)
    model = lm.LM(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    blk = model.stages["s0_gspn"][0][0]
    e = model.embed.detach()
    assert e.abs().max() <= 0.04 and abs(e.std().item() - 0.0176) < 0.001
    g = blk.ffn.gate.detach() * 16.0
    assert g.abs().max() <= 2.0 and abs(g.std().item() - 0.880) < 0.02
    d = blk.mix.w_lam.detach() * 16.0
    assert d.abs().max() <= 1.0 and abs(d.std().item() - 3 ** -0.5) < 0.03
    for m in (blk.ln1, blk.ln2, model.ln_f):
        assert torch.all(m.scale == 1)


def test_configs_match_the_reference():
    for make in ("full", "reduced"):
        mine = getattr(tq, make)()
        theirs = getattr(jq, make)()
        for f in dataclasses.fields(mine):
            if f.name == "gspn_impl":
                assert mine.gspn_impl == "auto"
                continue
            want = getattr(theirs, f.name)
            got = getattr(mine, f.name)
            if isinstance(got, torch.dtype):
                want = getattr(torch, str(jnp.dtype(want)))
            assert got == want, (make, f.name)
    for name, p in tbase.PRECISIONS.items():
        jp = jbase.PRECISIONS[name]
        assert [str(d).removeprefix("torch.") for d in
                (p.param_dtype, p.compute_dtype, p.carry_dtype)] == \
            [str(jnp.dtype(d)) for d in
             (jp.param_dtype, jp.compute_dtype, jp.carry_dtype)], name
    f32 = tbase.with_precision(tq.reduced(), "f32")
    assert (f32.compute_dtype, f32.gspn_compute_dtype) == \
        (torch.float32, torch.float32)
    assert tbase.resolve_dtype("bf16") is torch.bfloat16
    assert set(tbase.SHAPES) == set(jbase.SHAPES)
    with pytest.raises(ValueError):
        tbase.resolve_precision("fp8")


def test_registry_runs_only_what_the_port_runs():
    ported = ["granite-3-2b", "qwen1.5-32b", "qwen2-1.5b", "qwen2-1.5b-gspn",
              "qwen2.5-3b"]
    assert tbase.list_archs() == ported
    assert tbase.get_arch("qwen2-1.5b-gspn").full().n_layers == 28
    for name in jbase.list_archs():
        if name in ported:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tbase.get_arch(name)
    with pytest.raises(KeyError):
        tbase.get_arch("no-such-arch")
    moe = dataclasses.replace(tq.reduced(), unit=(("attn_moe", 2),))
    with pytest.raises(NotImplementedError, match="item 3.6"):
        lm.LM(moe, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm.init_lm_cache(moe, 1, 8, device="cpu")
    assert not lm.supports_chunked_prefill(moe)
    with pytest.raises(ValueError, match="unknown block kind"):
        lm.LM(dataclasses.replace(tq.reduced(), unit=(("conv", 2),)),
              device="meta")
    with pytest.raises(NotImplementedError, match="item 6"):
        lm.Ctx(mesh=object())


# ---------------------------------------------------------------------------
# The LM.
# ---------------------------------------------------------------------------

def _lm(cfg_j, cfg_t, seed=0):
    params = jlm.init_lm(jax.random.PRNGKey(seed), cfg_j)
    model = lm.LM(cfg_t, device="meta")
    model.load_state_dict(
        lm_state_from_jax(jax.tree.map(np.asarray, params)), assign=True)
    return params, model


def _reduced(precision=None, **kw):
    cj, ct = jq.reduced(), tq.reduced()
    if precision:
        cj = jbase.with_precision(cj, precision)
        ct = tbase.with_precision(ct, precision)
    return (dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw))


def _tokens(seed, batch, length, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, length)).astype(np.int32)


def _run_both(cj, ct, toks, chunks, decode_steps=2):
    """Forward, prefill, a chunk chain and ``decode_steps`` decode steps
    on both sides; returns {what: (port, reference)}."""
    params, model = _lm(cj, ct)
    t = torch.from_numpy(toks).long()
    out = {"apply_lm": (lm.apply_lm(model, t),
                        jlm.apply_lm(params, cj, jnp.asarray(toks))[0])}
    logits, caches = lm.lm_prefill(model, t, 64)
    jlogits, jcaches, _ = jlm.lm_prefill(params, cj, jnp.asarray(toks), 64)
    out["lm_prefill"] = (logits, jlogits)
    out["lm_prefill caches"] = (caches, jcaches)

    b = toks.shape[0]
    c = lm.init_lm_cache(ct, b, 64, device="cpu")
    jc = jlm.init_lm_cache(cj, b, 64)
    lo, got, want = 0, [], []
    for size in chunks:
        lg, c = lm.lm_prefill_chunk(model, t[:, lo:lo + size], c, lo)
        jlg, jc = jlm.lm_prefill_chunk(params, cj,
                                       jnp.asarray(toks[:, lo:lo + size]),
                                       jc, lo)
        got.append(lg)
        want.append(jlg)
        lo += size
    out["lm_prefill_chunk"] = (torch.cat(got, 1), jnp.concatenate(want, 1))
    out["lm_prefill_chunk caches"] = (c, jc)

    tok = np.argmax(np.asarray(jlogits, np.float32)[:, -1:], -1)
    got, want = [], []
    for _ in range(decode_steps):
        lg, caches = lm.lm_decode_step(model, torch.from_numpy(tok).long(),
                                       caches)
        jlg, jcaches = jlm.lm_decode_step(params, cj,
                                          jnp.asarray(tok, jnp.int32),
                                          jcaches)
        got.append(lg)
        want.append(jlg)
        tok = np.argmax(np.asarray(jlg, np.float32), -1)
    out["lm_decode_step"] = (torch.cat(got, 1), jnp.concatenate(want, 1))
    out["lm_decode_step caches"] = (caches, jcaches)
    return out


def test_lm_matches_jax_at_f32():
    """apply_lm, lm_prefill, lm_prefill_chunk and lm_decode_step from
    converted parameters: logits 1e-4, every cache leaf 1e-5."""
    cj, ct = _reduced("f32")
    with torch.no_grad():
        out = _run_both(cj, ct, _tokens(0, 2, 21), [8, 8, 5])
    for what, (got, want) in out.items():
        if what.endswith("caches"):
            _tree_close(got, want)
        else:
            assert got.shape == want.shape == (2,) + got.shape[1:2] + (512,)
            _close(got, want, LOGITS_TOL, what)


def test_lm_matches_jax_under_its_own_bf16_policy():
    """The config's own policy (f32 parameters, bf16 compute, the mixer in
    f32): logits and every cache leaf within 1e-2 in relative L2."""
    cj, ct = _reduced()
    assert ct.compute_dtype == torch.bfloat16
    with torch.no_grad():
        out = _run_both(cj, ct, _tokens(1, 2, 19), [16, 3])
    for what, (got, want) in out.items():
        if what.endswith("caches"):
            for key in want:
                for name in want[key]:
                    assert _rel_l2(got[key][name], want[key][name]) \
                        <= BF16_TOL, (what, name)
        else:
            assert got.dtype == torch.bfloat16
            assert _rel_l2(got, want) <= BF16_TOL, what


def test_prelude_and_repeated_unit_layout_matches_jax():
    """A gspn prelude and a unit of one gspn block repeated twice: the
    converter unstacks both layouts, and the caches keep the reference's
    (n, B, ...) and (n_units, n, B, ...) leading axes."""
    cj, ct = _reduced("f32", prelude=(("gspn", 1),), unit=(("gspn", 1),),
                      n_units=2, n_layers=3)
    with torch.no_grad():
        out = _run_both(cj, ct, _tokens(2, 1, 11), [8, 3], decode_steps=1)
    caches = out["lm_prefill caches"][0]
    assert caches["s0_gspn"]["prev_row"].shape == (1, 1, 4, 8)
    assert caches["s1_gspn"]["prev_row"].shape == (2, 1, 1, 4, 8)
    for what, (got, want) in out.items():
        if what.endswith("caches"):
            _tree_close(got, want)
        else:
            _close(got, want, LOGITS_TOL, what)


def test_chunk_chain_equals_one_shot_and_decode_equals_forward():
    """The port's own invariants at f32: a chunk chain (ragged tail) gives
    the one-shot prefill's logits and every cache leaf; decoding the next
    tokens from either cache gives apply_lm's logits at those
    positions."""
    _, ct = _reduced("f32")
    model = lm.LM(ct, device="cpu",
                  generator=torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_tokens(3, 2, 30)).long()
    with torch.no_grad():
        full = lm.apply_lm(model, toks)
        logits, caches = lm.lm_prefill(model, toks[:, :27], 30)
        _close(logits, full[:, :27], LOGITS_TOL)
        c = lm.init_lm_cache(ct, 2, 30, device="cpu")
        outs = []
        for lo, hi in ((0, 16), (16, 24), (24, 27)):
            lg, c = lm.lm_prefill_chunk(model, toks[:, lo:hi], c, lo,
                                        with_logits=hi == 27)
            outs.append(lg)
        assert outs[0] is None and outs[1] is None
        _close(outs[2], logits[:, 24:], LOGITS_TOL)
        _tree_close(c, caches)
        for cache in (caches, c):
            got = []
            for i in range(27, 30):
                lg, cache = lm.lm_decode_step(model, toks[:, i:i + 1], cache)
                got.append(lg)
            _close(torch.cat(got, 1), full[:, 27:], LOGITS_TOL)
    with pytest.raises(ValueError, match="grid-row boundary"):
        lm.lm_prefill_chunk(model, toks[:, 3:9], c, 3)
    assert lm.supports_chunked_prefill(ct)
    assert lm.prefill_chunk_alignment(ct) == 8
    assert not lm.supports_chunked_prefill(
        dataclasses.replace(ct, gspn_row_width=0))
    assert lm.count_params(model) == sum(
        np.asarray(a).size for a in jax.tree.leaves(jlm.init_lm(
            jax.random.PRNGKey(0), jq.reduced())))


def test_cpu_path_calls_the_plain_scan_two_times_a_layer():
    _, ct = _reduced("f32")
    model = lm.LM(ct, device="cpu")
    toks = torch.from_numpy(_tokens(5, 1, 12)).long()
    cuda_lib.clear_counts()
    with torch.no_grad():
        _, caches = lm.lm_prefill(model, toks, 12)
        assert cuda_lib.plain_calls["gspn_scan_fwd"] == 2 * ct.n_layers
        lm.lm_decode_step(model, toks[:, :1], caches)
    assert cuda_lib.plain_calls["gspn_scan_fwd"] == 2 * ct.n_layers
    assert not cuda_lib.launch_counts


def test_converter_carries_every_leaf_and_refuses_the_rest():
    cj, _ = _reduced("f32")
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), cj))
    state = lm_state_from_jax(params)
    assert len(state) == 2 + 2 * 11
    assert state["stages.s0_gspn.0.1.mix.w_row"].shape == (48, 1)
    missing = {**params, "stages": {"s0_gspn": {
        k: v for k, v in params["stages"]["s0_gspn"].items() if k != "ln2"}}}
    with pytest.raises(KeyError, match="ln2"):
        lm_state_from_jax(missing)
    with pytest.raises(ValueError, match="no counterpart"):
        lm_state_from_jax({**params, "extra": np.zeros(3)})


def test_long_context_example_streams_on_the_cpu(capsys):
    """The twin of examples/long_context_gspn.py at --ctx 256: rows of
    16, an O(W) cache, and streamed logits equal to the full forward's
    (the script checks them itself)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "long_context_gspn_torch.py"
    spec = importlib.util.spec_from_file_location("long_context_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.main(["--ctx", "256", "--stream", "8", "--device", "cpu"])
    assert got.shape == (1, 8, 512) and torch.isfinite(got).all()
    out = capsys.readouterr().out
    assert "folded into rows of 16" in out
    assert "outputs match full forward" in out
