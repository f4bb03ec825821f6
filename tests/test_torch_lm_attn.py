"""The port's ``attn`` block kind and its four configurations against the
JAX reference package: ``qwen2-1.5b``, ``qwen2.5-3b``, ``granite-3-2b``
and ``qwen1.5-32b``.

On each ``reduced()`` config, from ``lm_state_from_jax`` of the
reference's ``init_lm``: ``apply_lm`` logits, ``lm_prefill`` and its KV
caches, a chunk chain and decode steps, ``lm_loss`` and its gradients and
one ``build_train_step`` step; the blockwise attention path inside the
LM, with and without ``remat="unit"``; the cache-capacity guards; each
``full()`` built on the ``meta`` device with the reference's parameter
count; the configs and their registry entries field by field.

Tolerances: under ``with_precision(cfg, "f32")`` 1e-4 of the largest
magnitude for logits and gradients and 1e-5 for cache leaves, the loss
1e-5 relative; under the config's own policy (bf16 products) 1e-2 in
relative L2 for logits and caches; the train step with the bounds and
noise-floor rule of ``tests/test_torch_train_lm.py``.  On the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import granite_3_2b as jgranite
from repro.configs import qwen1_5_32b as jqwen15
from repro.configs import qwen2_1_5b as jqwen2
from repro.configs import qwen2_5_3b as jqwen25
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import base as tbase
from repro_torch.configs import granite_3_2b as tgranite
from repro_torch.configs import qwen1_5_32b as tqwen15
from repro_torch.configs import qwen2_1_5b as tqwen2
from repro_torch.configs import qwen2_5_3b as tqwen25
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep

ARCHS = {"qwen2-1.5b": (jqwen2, tqwen2), "qwen2.5-3b": (jqwen25, tqwen25),
         "granite-3-2b": (jgranite, tgranite),
         "qwen1.5-32b": (jqwen15, tqwen15)}
NAMES = sorted(ARCHS)
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


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _reduced(name, precision=None, **kw):
    jmod, tmod = ARCHS[name]
    cj, ct = jmod.reduced(), tmod.reduced()
    if precision:
        cj = jbase.with_precision(cj, precision)
        ct = tbase.with_precision(ct, precision)
    return dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)


def _lm(cj, ct, seed=0):
    """The reference's parameters (the qkv biases, zero at init, drawn at
    random so that they count) and the port's LM holding them."""
    params = jlm.init_lm(jax.random.PRNGKey(seed), cj)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = str(path[-1].key)
        if name in ("bq", "bk", "bv"):
            return jnp.asarray(rng.standard_normal(a.shape) * 0.5, a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    model = lm.LM(ct, device="meta")
    model.load_state_dict(
        lm_state_from_jax(jax.tree.map(np.asarray, params)), assign=True)
    return params, model


def _tokens(seed, batch, length, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, length)).astype(np.int32)


MAX_LEN = 32
# The reference's entry points compiled once per config (and chunk length):
# unjitted, each call would trace its layer scans anew.
_apply = jax.jit(jlm.apply_lm, static_argnums=1)
_prefill = jax.jit(jlm.lm_prefill, static_argnums=(1, 3))
_chunk = jax.jit(jlm.lm_prefill_chunk, static_argnums=1)
_decode = jax.jit(jlm.lm_decode_step, static_argnums=1)


def _run_both(cj, ct, toks, chunks, decode_steps=3):
    """Forward, prefill, a chunk chain and decode steps on both sides;
    returns {what: (port, reference)}.  The reference's caches nest an
    attn stage's leaves under "attn"; the port's hold them directly."""
    params, model = _lm(cj, ct)
    t = torch.from_numpy(toks).long()
    out = {"apply_lm": (lm.apply_lm(model, t),
                        _apply(params, cj, jnp.asarray(toks))[0])}
    logits, caches = lm.lm_prefill(model, t, MAX_LEN)
    jlogits, jcaches, _ = _prefill(params, cj, jnp.asarray(toks), MAX_LEN)
    out["lm_prefill"] = (logits, jlogits)
    out["lm_prefill caches"] = (caches, jcaches)

    b = toks.shape[0]
    c = lm.init_lm_cache(ct, b, MAX_LEN, device="cpu")
    jc = jlm.init_lm_cache(cj, b, MAX_LEN)
    lo, got, want = 0, [], []
    for size in chunks:
        lg, c = lm.lm_prefill_chunk(model, t[:, lo:lo + size], c, lo)
        jlg, jc = _chunk(params, cj, jnp.asarray(toks[:, lo:lo + size]),
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
        jlg, jcaches = _decode(params, cj, jnp.asarray(tok, jnp.int32),
                               jcaches)
        got.append(lg)
        want.append(jlg)
        tok = np.argmax(np.asarray(jlg, np.float32), -1)
    out["lm_decode_step"] = (torch.cat(got, 1), jnp.concatenate(want, 1))
    out["lm_decode_step caches"] = (caches, jcaches)
    return out


def _leaves(got, want):
    """(name, port leaf, reference leaf) of every cache leaf."""
    assert sorted(got) == sorted(want)
    for key in want:
        ref = want[key]["attn"] if key.endswith("_attn") else want[key]
        assert sorted(got[key]) == sorted(ref)
        for name in ref:
            yield f"{key}/{name}", got[key][name], ref[name]


# ---------------------------------------------------------------------------
# Configs and the registry.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_configs_and_entries_match_the_reference(name):
    jmod, tmod = ARCHS[name]
    for make in ("full", "reduced"):
        mine, theirs = getattr(tmod, make)(), getattr(jmod, make)()
        for f in dataclasses.fields(mine):
            if f.name == "gspn_impl":
                continue
            want, got = getattr(theirs, f.name), getattr(mine, f.name)
            if isinstance(got, torch.dtype):
                want = getattr(torch, str(jnp.dtype(want)))
            assert got == want, (make, f.name)
        assert mine.hd == theirs.hd
    mine, theirs = tbase.get_arch(name), jbase.get_arch(name)
    assert (mine.name, mine.family, mine.skip_shapes, mine.source) == \
        (theirs.name, theirs.family, theirs.skip_shapes, theirs.source)
    assert tbase.FULL_ATTENTION_SKIP == jbase.FULL_ATTENTION_SKIP


def test_registry_runs_the_attention_archs():
    assert set(NAMES) | {"qwen2-1.5b-gspn"} == set(tbase.list_archs())
    for name in NAMES:
        assert name not in tbase.NOT_PORTED
    assert tbase.get_arch("qwen2-1.5b").full().unit == (("attn", 28),)


# The reference's parameter counts of the full configs, from jax.eval_shape
# (no weights drawn): 1 543 714 304 for qwen2-1.5b.
@pytest.mark.parametrize("name", NAMES)
def test_full_config_builds_on_meta_with_the_reference_count(name):
    jmod, tmod = ARCHS[name]
    shapes = jax.eval_shape(lambda k: jlm.init_lm(k, jmod.full()),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = lm.LM(tmod.full(), device="meta")
    assert lm.count_params(model) == want
    if name == "qwen2-1.5b":
        assert abs(want - 1.544e9) < 1e6


# ---------------------------------------------------------------------------
# The LM against the reference.
# ---------------------------------------------------------------------------

# Attention alone chunks anywhere (alignment 1): three chunks of 6, one
# compile of the reference's chunk (the ragged chains are the port's own
# invariant below).
CHUNKS = [6, 6, 6]


@pytest.mark.parametrize("name", NAMES)
def test_lm_matches_jax_at_f32(name):
    """apply_lm, lm_prefill, a chunk chain and three decode steps: logits
    1e-4, every cache leaf 1e-5 (K after rope and V in the compute dtype,
    the length)."""
    cj, ct = _reduced(name, "f32")
    assert lm.supports_chunked_prefill(ct)
    assert lm.prefill_chunk_alignment(ct) == 1
    with torch.no_grad():
        out = _run_both(cj, ct, _tokens(0, 2, 18), CHUNKS)
    for what, (got, want) in out.items():
        if what.endswith("caches"):
            for leaf, g, w in _leaves(got, want):
                assert g.dtype == (torch.int32 if leaf.endswith("length")
                                   else torch.float32), leaf
                _close(g, w, TOL, f"{what} {leaf}")
        else:
            assert got.shape[-1] == 512
            _close(got, want, LOGITS_TOL, what)


@pytest.mark.parametrize("name", NAMES)
def test_lm_matches_jax_under_its_own_policy(name):
    """f32 parameters, bf16 products and a bf16 KV cache: logits and
    caches within 1e-2 relative L2."""
    cj, ct = _reduced(name)
    assert ct.compute_dtype == torch.bfloat16
    with torch.no_grad():
        out = _run_both(cj, ct, _tokens(1, 2, 18), CHUNKS, decode_steps=2)
    for what, (got, want) in out.items():
        if what.endswith("caches"):
            for leaf, g, w in _leaves(got, want):
                if leaf.endswith("length"):
                    assert g.tolist() == np.asarray(w).tolist()
                else:
                    assert g.dtype == torch.bfloat16, leaf
                    assert _rel_l2(g, w) <= BF16_TOL, (what, leaf)
        else:
            assert got.dtype == torch.bfloat16
            assert _rel_l2(got, want) <= BF16_TOL, what


def test_chunk_chain_equals_one_shot_and_decode_equals_forward():
    """The port's own invariants at f32 on the reduced qwen2-1.5b: a chunk
    chain gives the one-shot prefill's logits and caches; decoding from
    either gives apply_lm's logits at those positions."""
    _, ct = _reduced("qwen2-1.5b", "f32")
    model = lm.LM(ct, device="cpu",
                  generator=torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_tokens(3, 2, 24)).long()
    with torch.no_grad():
        full = lm.apply_lm(model, toks)
        logits, caches = lm.lm_prefill(model, toks[:, :20], MAX_LEN)
        _close(logits, full[:, :20], LOGITS_TOL)
        c = lm.init_lm_cache(ct, 2, MAX_LEN, device="cpu")
        for lo, hi in ((0, 3), (3, 14), (14, 20)):
            lg, c = lm.lm_prefill_chunk(model, toks[:, lo:hi], c, lo,
                                        with_logits=hi == 20)
        _close(lg, logits[:, 14:], LOGITS_TOL)
        for key in caches:
            for name in caches[key]:
                _close(c[key][name], caches[key][name], TOL, name)
        for cache in (caches, c):
            got = []
            for i in range(20, 24):
                lg, cache = lm.lm_decode_step(model, toks[:, i:i + 1], cache)
                got.append(lg)
            _close(torch.cat(got, 1), full[:, 20:], LOGITS_TOL)


def test_untied_head_of_qwen1_5():
    """qwen1.5-32b's head is its own (d_model, vocab) parameter, carried
    across and used for the logits; the tied configs have none."""
    cj, ct = _reduced("qwen1.5-32b", "f32")
    assert not ct.tie_embeddings
    params, model = _lm(cj, ct)
    assert model.head.shape == (64, 512)
    np.testing.assert_array_equal(_np(model.head), np.asarray(params["head"]))
    assert not hasattr(lm.LM(_reduced("qwen2-1.5b")[1], device="meta"),
                       "head")
    x = torch.randn(1, 3, 64)
    with torch.no_grad():
        torch.testing.assert_close(model.logits(x),
                                   model.ln_f(x) @ model.head)


def _loss_and_grads(model, batch):
    loss, parts = lm.lm_loss(model, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return loss.detach(), parts, dict(zip(names, grads))


def _batch(seed, n=2, seq=16):
    toks = _tokens(seed, n, seq + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_and_gradients_match_jax(name):
    """f32: the loss within 1e-5 relative, each gradient within 1e-4 of its
    leaf's largest magnitude, the qkv biases' included."""
    cj, ct = _reduced(name, "f32")
    params, model = _lm(cj, ct)
    b = _batch(2)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p, jb: jlm.lm_loss(p, cj, jb), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in b.items()})
    loss, parts, grads = _loss_and_grads(model, b)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert float(parts["aux"]) == 0.0
    want_g = lm_state_from_jax(jax.tree.map(np.asarray, want_g))
    assert grads.keys() == want_g.keys()
    assert any(n.endswith("attn.bq") for n in grads) == ct.qkv_bias
    for n, w in want_g.items():
        _close(grads[n], w, LOGITS_TOL, n)


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _first_step_direction(g, norm, cfg):
    """AdamW's first step moves each element by lr * phi(g) (plus decay):
    phi(g) = g / (|g| + eps) of the clipped gradient."""
    g = g.astype(np.float64) * min(cfg.grad_clip / float(norm), 1.0)
    return g / (np.abs(g) + cfg.eps)


@functools.lru_cache(maxsize=None)
def _step_outcome(name):
    """One train step on both sides from the same parameters and batch:
    (port metrics, reference metrics, {leaf: (|port - reference|, the
    leaf's largest parameter, the step noise the gradients predict, the
    reference's |g| over its leaf's largest)})."""
    cj, ct = _reduced(name, "f32")
    params, model = _lm(cj, ct)
    ocfg = AdamWConfig(**OPT)
    b = _batch(5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    gj = lm_state_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: jlm.lm_loss(p, cj, jb)[0]))(params)))
    gt = _loss_and_grads(model, b)[2]
    # The noise below is sized from the two gradients, so each must first
    # be the other's (a sign-flipped leaf would otherwise widen its bound).
    for n in gj:
        _close(gt[n], gj[n], LOGITS_TOL, f"gradient {n}")
    jstate = {"params": params,
              "opt": jadamw.adamw_init(jadamw.AdamWConfig(**OPT), params)}
    jstate, want = jax.jit(jstep.build_train_step(
        cj, jadamw.AdamWConfig(**OPT)))(jstate, jb)
    state = tstep.init_train_state(model, ocfg)
    state, got = tstep.build_train_step(model, ocfg)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    lr = float(want["lr"])
    leaves = {}
    for n, w in lm_state_from_jax(jax.tree.map(
            np.asarray, jstate["params"])).items():
        w, g = _np(w), _np(gj[n])
        noise = lr * np.abs(
            _first_step_direction(_np(gt[n]), got["grad_norm"], ocfg)
            - _first_step_direction(g, want["grad_norm"], ocfg))
        leaves[n] = (np.abs(_np(state["params"][n]) - w), np.abs(w).max(),
                     noise, np.abs(g) / np.abs(g).max())
    return got, want, leaves


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name):
    """One step of the port's ``build_train_step`` against one of the
    reference's (no mesh), AdamW decaying the qkv biases as the
    reference's mask does: loss 1e-5 relative, grad_norm 1e-6, lr 1e-6,
    and each parameter within 1e-5 of its leaf's largest plus twice the
    step noise that the port's and the reference's gradients (each
    clipped by its own norm) predict through AdamW's first step
    (test_first_step_turns_gradient_noise_into_parameter_noise)."""
    got, want, leaves = _step_outcome(name)
    for k, tol in (("loss", 1e-5), ("grad_norm", 1e-6), ("lr", 1e-6)):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=tol,
                                   err_msg=k)
    assert got["step"] == int(want["step"]) == 1
    for n, (diff, scale, noise, _) in leaves.items():
        assert (diff <= 1e-5 * scale + 2 * noise).all(), n


def test_first_step_turns_gradient_noise_into_parameter_noise():
    """Witness for the train-step bound: tests/test_torch_train_lm.py's
    fixed noise floor (an element off by more than 1e-5 must have |g|
    under 1e-5 of its leaf's largest) is not met on granite-3-2b's
    reduced config.  Near eps, AdamW's first step lr * g / (|g| + eps)
    turns the gradients' f32 disagreement (about 1e-6 of each leaf's
    largest) into a share of the step: an ffn.up element with |g| at
    1.13e-5 of its leaf's largest ends 1.08e-5 of its leaf's largest
    parameter apart, and every element off by more than 1e-5 sits within
    1% of the step noise its two gradients predict."""
    _, _, leaves = _step_outcome("granite-3-2b")
    beyond = [(n, r[off].max()) for n, (diff, scale, noise, r)
              in leaves.items() for off in [diff > 1e-5 * scale] if off.any()]
    assert any(r > 1e-5 for _, r in beyond), beyond
    for n, (diff, scale, noise, _) in leaves.items():
        off = diff > 1e-5 * scale
        np.testing.assert_allclose(diff[off], noise[off], rtol=1e-2,
                                   err_msg=n)


def test_blockwise_attention_in_the_lm_matches_jax(monkeypatch):
    """attn_block_k 8 under 20 tokens: the LM takes the blockwise path
    (block 4 after halving) on both sides; logits and gradients against
    the reference, and remat="unit" runs the blockwise forward again in
    the backward with the same loss and gradients."""
    cj, ct = _reduced("qwen2-1.5b", "f32", attn_block_k=8)
    params, model = _lm(cj, ct)
    calls = []
    real = attn._flash_fwd
    monkeypatch.setattr(attn, "_flash_fwd",
                        lambda *a: calls.append(a[3]) or real(*a))
    b = _batch(6, seq=20)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, cj, jb), has_aux=True))(params)
    want_g = lm_state_from_jax(jax.tree.map(np.asarray, want_g))
    out = {}
    for remat in ("none", "unit"):
        model.cfg = dataclasses.replace(ct, remat=remat)
        calls.clear()
        out[remat] = _loss_and_grads(model, b)
        assert calls == [4] * (2 if remat == "none" else 4), remat
    loss, _, grads = out["none"]
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for n, w in want_g.items():
        _close(grads[n], w, LOGITS_TOL, n)
        _close(out["unit"][2][n], grads[n], 1e-6, f"unit {n}")
    np.testing.assert_allclose(float(out["unit"][0]), float(loss), rtol=1e-6)
    with torch.no_grad():
        _close(lm.apply_lm(model, torch.from_numpy(b["tokens"]).long()),
               _apply(params, cj, jb["tokens"])[0], LOGITS_TOL)


def test_cache_capacity_is_guarded():
    """The reference clamps a chunk's write offset and pads a prompt by a
    negative width past max_len, silently; the port raises."""
    _, ct = _reduced("qwen2-1.5b", "f32")
    model = lm.LM(ct, device="cpu")
    toks = torch.from_numpy(_tokens(7, 1, 12)).long()
    with torch.no_grad():
        with pytest.raises(ValueError, match=r"prompt of 12 tokens does not "
                                             r"fit the KV cache's max_len=8"):
            lm.lm_prefill(model, toks, 8)
        c = lm.init_lm_cache(ct, 1, 10, device="cpu")
        _, c = lm.lm_prefill_chunk(model, toks[:, :6], c, 0)
        with pytest.raises(ValueError, match=r"chunk of 6 tokens at offset 6 "
                                             r"does not fit the KV cache's "
                                             r"max_len=10"):
            lm.lm_prefill_chunk(model, toks[:, 6:], c, 6)
        lm.lm_prefill_chunk(model, toks[:, 6:10], c, 6)    # fits exactly


def test_mixed_attn_and_gspn_stages_match_jax():
    """An attn prelude before a gspn unit repeated twice: the converter
    unstacks both kinds, the caches keep the reference's layout, chunks
    snap to the fold width, and logits, prefill and decode match."""
    cj, ct = _reduced("qwen2-1.5b", "f32", prelude=(("attn", 1),),
                      unit=(("gspn", 1),), n_units=2, n_layers=3,
                      gspn_proxy_dim=4, gspn_row_width=8)
    assert lm.prefill_chunk_alignment(ct) == 8
    with torch.no_grad():
        out = _run_both(cj, ct, _tokens(8, 1, 16), [8, 8], decode_steps=1)
    caches = out["lm_prefill caches"][0]
    assert caches["s0_attn"]["k"].shape == (1, 1, MAX_LEN, 2, 8)
    assert caches["s1_gspn"]["prev_row"].shape == (2, 1, 1, 4, 8)
    for what, (got, want) in out.items():
        if what.endswith("caches"):
            for leaf, g, w in _leaves(got, want):
                _close(g, w, TOL, f"{what} {leaf}")
        else:
            _close(got, want, LOGITS_TOL, what)
