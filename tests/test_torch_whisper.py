"""The encoder-decoder family against the JAX reference package: the
non-causal attention, the GELU MLP under the policy's casts, whisper's
encoder and ``enc_kv``, the ``xattn`` block kind, and ``whisper-base``'s
reduced config end to end.

On ``whisper-reduced`` from ``lm_state_from_jax`` of the reference's
``init_lm``: ``lm_encode`` against the third value of the reference's
``lm_prefill``, ``apply_lm`` with ``enc_frames``, ``lm_prefill`` and
decode steps with ``enc_kv`` (logits and every cache leaf), the loss and
every gradient, the encoder's included, under ``remat`` "none" and
"unit", with exact zeros on ``xattn/wk`` and ``xattn/wv``; one
``build_train_step`` step; ``host_batch`` with ``enc_len``; the engine's
and the serve launcher's refusal; the config and the full config's
counts.

Tolerances: f32 1e-5 of the largest magnitude (attention, the encoder's
keys and values, cache leaves), logits and gradients 1e-4, a loss 1e-5
relative, 1e-2 relative L2 under the config's own policy (bf16 products,
DESIGN.md §10).  On the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import whisper_base as jwh
from repro.data import pipeline as jpipe
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import base as tbase
from repro_torch.configs import whisper_base as twh
from repro_torch.data import pipeline
from repro_torch.models import attention as attn
from repro_torch.models import layers, lm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.optim.adamw import AdamWConfig, decays
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep

TOL = 1e-5
LOGITS_TOL = 1e-4
BF16_TOL = 1e-2
MAX_LEN = 24
B, S, T = 2, 12, 32           # clips, prompt tokens, frames (enc_len)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _pair(precision=None, **kw):
    cj, ct = jwh.reduced(), twh.reduced()
    if precision:
        cj = jbase.with_precision(cj, precision)
        ct = tbase.with_precision(ct, precision)
    return dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)


def _lm(cj, ct, seed=0):
    """The reference's parameters (the layernorms' scales and biases and
    the GELU MLPs' biases, 1 and 0 at init, drawn at random so that they
    count) and the port's LM holding them."""
    params = jlm.init_lm(jax.random.PRNGKey(seed), cj)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = str(path[-1].key)
        if name in ("bias", "b1", "b2"):
            return jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
        if name == "scale":
            return jnp.asarray(1 + rng.standard_normal(a.shape) * 0.1,
                               a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    model = lm.LM(ct, device="meta")
    model.load_state_dict(
        lm_state_from_jax(jax.tree.map(np.asarray, params)), assign=True)
    return params, model


def _inputs(seed, n=B, s=S, t=T, d=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (n, s)).astype(np.int32),
            rng.standard_normal((n, t, d)).astype(np.float32))


_apply = jax.jit(jlm.apply_lm, static_argnums=1)
_prefill = jax.jit(jlm.lm_prefill, static_argnums=(1, 3))
_decode = jax.jit(jlm.lm_decode_step, static_argnums=1)


# ---------------------------------------------------------------------------
# The layers: non-causal attention, the GELU MLP.
# ---------------------------------------------------------------------------

def _qkv(seed, sq, sk, hkv=1, g=2, d=4, b=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    ct = rng.standard_normal((b, sq, hkv * g, d)).astype(np.float32)
    return q, k, v, ct


@pytest.mark.parametrize("sq", [1500, 7, 1])
def test_non_causal_chunked_attention_matches_jax(monkeypatch, sq):
    """1500 keys with block_k 512, halved to 4 on both sides (375 blocks):
    the encoder's self-attention (1500 queries), a cross-attention (7)
    and a decode step's (1); the output and the adjoint's dq, dk, dv
    within 1e-5 of the largest magnitude of the reference's, and the
    output within 1e-5 of the dense non-causal path's."""
    seen = []
    real = attn._fwd_blocks
    monkeypatch.setattr(attn, "_fwd_blocks",
                        lambda *a: seen.append(a[3:]) or real(*a))
    q, k, v, ct = _qkv(sq, sq, 1500)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = attn.chunked_attention(*ts, causal=False, block_k=512)
    grads = torch.autograd.grad(out, ts, _t(ct))
    assert seen == [(4, False)]
    want, vjp = jax.vjp(lambda *a: jattn.chunked_attention(
        *a, causal=False, block_k=512), *map(jnp.asarray, (q, k, v)))
    _close(out, want, TOL, "out")
    for name, g, w in zip("qkv", grads, vjp(jnp.asarray(ct))):
        _close(g, w, TOL, f"d{name}")
    with torch.no_grad():
        _close(out, attn.full_attention(*ts, causal=False), TOL, "dense")


def test_non_causal_dense_attention_matches_jax():
    """full_attention(causal=False) against the reference's, and the
    causal mask changes every row but the last."""
    q, k, v, _ = _qkv(2, 9, 9, hkv=2, g=3)
    got = attn.full_attention(*map(_t, (q, k, v)), causal=False)
    _close(got, jattn.full_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=False), TOL)
    causal = attn.full_attention(*map(_t, (q, k, v)))
    differs = (got != causal).flatten(2).any(-1)[0]
    assert differs[:-1].all() and not differs[-1]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_gelu_mlp_matches_jax_under_the_policy(precision):
    """The GELU MLP with biases under f32 parameters and f32 or bf16
    products against the reference's apply_gelu_mlp: 1e-5 of the largest
    in f32, 1e-2 relative L2 under bf16 (whose output is bf16 for bf16
    input and f32 for f32 input, as the reference's)."""
    cd = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}[precision]
    pol = layers.DTypePolicy(torch.float32, cd[0])
    jpol = jlayers.DTypePolicy(jnp.float32, cd[1])
    rng = np.random.default_rng(7)
    p = jlayers.init_gelu_mlp(jax.random.PRNGKey(7), 16, 40)
    p = {k: jnp.asarray(rng.standard_normal(v.shape) * 0.3, v.dtype)
         if k.startswith("b") else v for k, v in p.items()}
    mlp = layers.GeluMLP(16, 40, pol, generator=None, device="meta")
    mlp.load_state_dict({k: _t(np.asarray(v)) for k, v in p.items()},
                        assign=True)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    for xdt in (torch.float32, cd[0]):
        xt = _t(x).to(xdt)
        jx = jnp.asarray(xt.float().numpy()).astype(
            jnp.float32 if xdt == torch.float32 else cd[1])
        with torch.no_grad():
            got = mlp(xt)
        want = jax.jit(lambda p_, x_: jlayers.apply_gelu_mlp(p_, x_, jpol))(
            p, jx)
        assert got.dtype == xdt
        if precision == "f32":
            _close(got, want, TOL, str(xdt))
        else:
            assert _rel_l2(got, want) <= BF16_TOL, xdt


def test_xla_rounds_a_bf16_gelu_at_each_step():
    """Witness for the bf16 bounds of this file: the reference's
    ``jax.nn.gelu`` on bf16 input is a chain of jnp operations (x³, the
    tanh argument, tanh, 1 + tanh, the halving, the product), each
    rounded to bf16, where PyTorch's ``gelu`` computes in f32 and rounds
    once.  Over 4001 bf16 inputs in [-6, 6] PyTorch's equals the f32 GELU
    rounded once, bit for bit; XLA's differs from it on about 40% of them
    (its largest error against the f64 GELU is 9.3e-3, PyTorch's 7.8e-3),
    6.7e-4 apart in relative L2: well inside the 1e-2 relative L2 that the
    bf16 tests hold, which is neither tightened nor loosened here."""
    v = torch.linspace(-6, 6, 4001).bfloat16()
    torch_bf16 = torch.nn.functional.gelu(v, approximate="tanh")
    once = torch.nn.functional.gelu(v.float(), approximate="tanh").bfloat16()
    assert torch.equal(torch_bf16, once)
    xla = torch.from_numpy(np.asarray(
        jax.nn.gelu(jnp.asarray(v.float().numpy(), jnp.bfloat16)),
        np.float32))
    assert 0.2 < (xla != once.float()).float().mean() < 0.6
    exact = torch.nn.functional.gelu(v.double(), approximate="tanh")
    assert (xla.double() - exact).abs().max() > \
        (once.double() - exact).abs().max()
    assert _rel_l2(xla, once) < 1e-3


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_runs():
    """The reduced model under f32 on both sides: {what: (port,
    reference)}: lm_encode and the reference lm_prefill's enc_kv,
    apply_lm with enc_frames, lm_prefill with enc_kv (logits, caches),
    3 decode steps with enc_kv (logits, caches), and apply_lm without
    frames (no cross-attention on either side)."""
    cj, ct = _pair("f32")
    params, model = _lm(cj, ct)
    toks, frames = _inputs(0)
    jt, jf = jnp.asarray(toks), jnp.asarray(frames)
    t, tf = _t(toks).long(), _t(frames)
    out = {}
    with torch.no_grad():
        out["apply_lm frames"] = (lm.apply_lm(model, t, enc_frames=tf),
                                  _apply(params, cj, jt, enc_frames=jf)[0])
        out["apply_lm no frames"] = (lm.apply_lm(model, t),
                                     _apply(params, cj, jt)[0])
        kv = lm.lm_encode(model, tf)
        jlogits, jcaches, jkv = _prefill(params, cj, jt, MAX_LEN,
                                         enc_frames=jf)
        out["lm_encode k"] = (kv[0], jkv[0])
        out["lm_encode v"] = (kv[1], jkv[1])
        logits, caches = lm.lm_prefill(model, t, MAX_LEN, enc_kv=kv)
        out["lm_prefill"] = (logits, jlogits)
        out["lm_prefill caches"] = (caches, jcaches)
        tok = np.argmax(np.asarray(jlogits)[:, -1:], -1).astype(np.int32)
        got, want = [], []
        for _ in range(3):
            lg, caches = lm.lm_decode_step(model, _t(tok).long(), caches,
                                           enc_kv=kv)
            jlg, jcaches = _decode(params, cj, jnp.asarray(tok), jcaches,
                                   enc_kv=jkv)
            got.append(lg)
            want.append(jlg)
            tok = np.argmax(np.asarray(jlg), -1).astype(np.int32)
        out["lm_decode_step"] = (torch.cat(got, 1), jnp.concatenate(want, 1))
        out["lm_decode_step caches"] = (caches, jcaches)
    return out


F32_CASES = ("apply_lm frames", "apply_lm no frames", "lm_encode k",
             "lm_encode v", "lm_prefill", "lm_prefill caches",
             "lm_decode_step", "lm_decode_step caches")


@pytest.mark.parametrize("case", F32_CASES)
def test_lm_paths_match_jax_at_f32(f32_runs, case):
    """Logits within 1e-4 of the largest; the encoder's keys and values
    and every KV cache leaf within 1e-5 (the reference nests an xattn
    stage's leaves under "attn")."""
    got, want = f32_runs[case]
    if case.endswith("caches"):
        assert sorted(got) == sorted(want) == ["s0_xattn"]
        for name, w in want["s0_xattn"]["attn"].items():
            _close(got["s0_xattn"][name], w, TOL, f"{case} {name}")
        return
    if case.startswith("lm_encode"):
        assert got.shape == (B, T, 4, 16)
        _close(got, want, TOL, case)
        return
    assert got.shape[-1] == 512
    _close(got, want, LOGITS_TOL, case)


def test_cross_attention_reads_the_frames():
    """Other frames change every logit; without frames the decoder runs
    no cross-attention, as the reference's does; the encoder's stream
    stays f32 under bf16 products and its keys and values are bf16."""
    _, ct = _pair()
    model = lm.LM(ct, device="cpu", generator=torch.Generator().manual_seed(1))
    toks, frames = _inputs(1)
    t, tf = _t(toks).long(), _t(frames)
    with torch.no_grad():
        a = lm.apply_lm(model, t, enc_frames=tf)
        # Not tf + 1: the layernorms remove a shift of every feature.
        b = lm.apply_lm(model, t, enc_frames=tf * 2)
        none = lm.apply_lm(model, t)
        assert model.encoder(tf).dtype == torch.float32
        kv = lm.lm_encode(model, tf)
    assert (a != b).any(-1).all() and (a != none).any(-1).all()
    assert all(x.dtype == torch.bfloat16 for x in kv)
    with pytest.raises(ValueError, match="has no encoder"):
        lm.lm_encode(lm.LM(dataclasses.replace(ct, encoder_layers=0,
                                               unit=(("attn", 2),)),
                           device="meta"), tf)


def test_lm_matches_jax_under_its_own_policy():
    """f32 parameters, bf16 products: apply_lm with frames, the encoder's
    keys and values, and the prefill with enc_kv within 1e-2 relative L2
    (test_xla_rounds_a_bf16_gelu_at_each_step)."""
    cj, ct = _pair()
    params, model = _lm(cj, ct, seed=2)
    toks, frames = _inputs(2)
    jt, jf = jnp.asarray(toks), jnp.asarray(frames)
    with torch.no_grad():
        got = lm.apply_lm(model, _t(toks).long(), enc_frames=_t(frames))
        kv = lm.lm_encode(model, _t(frames))
        logits, _ = lm.lm_prefill(model, _t(toks).long(), MAX_LEN,
                                  enc_kv=kv)
    jlogits, _, jkv = _prefill(params, cj, jt, MAX_LEN, enc_frames=jf)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, _apply(params, cj, jt, enc_frames=jf)[0]) <= BF16_TOL
    for g, w in zip(kv, jkv):
        assert _rel_l2(g, w) <= BF16_TOL
    assert _rel_l2(logits, jlogits) <= BF16_TOL


def test_encoder_decoder_prefills_in_one_shot():
    """No chunked prefill for an encoder-decoder model, as the
    reference's rule says; lm_prefill_chunk refuses the xattn kind."""
    _, ct = _pair("f32")
    assert not lm.supports_chunked_prefill(ct)
    assert not lm.supports_chunked_prefill(
        dataclasses.replace(ct, unit=(("attn", 2),)))
    model = lm.LM(ct, device="cpu")
    c = lm.init_lm_cache(ct, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="xattn kind has no chunked"):
        lm.lm_prefill_chunk(model, torch.zeros(1, 4, dtype=torch.long), c, 0)


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def _batch(seed, n=B, seq=S):
    """The training batch the launcher draws for an audio model:
    host_batch with enc_len and d_model."""
    return pipeline.host_batch(pipeline.DataConfig(
        vocab=512, seq_len=seq, global_batch=n, seed=seed, enc_len=T,
        d_model=64), 0)


def _loss_and_grads(model, batch):
    """(loss, parts, {name: gradient}); a parameter the loss does not
    read gets None."""
    loss, parts = lm.lm_loss(model, {k: _t(v) for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()],
                                allow_unused=True)
    return loss.detach(), parts, dict(zip(names, grads))


UNREAD = ("xattn.wk", "xattn.wv")


def test_host_batch_draws_the_frames_as_the_reference():
    """enc_len (and vision_len beside it) with d_model: tokens, labels,
    vision embeddings and frames bit for bit the reference's, drawn in
    that order from one generator of the step."""
    for seed, step, vision in ((0, 0, 0), (2, 7, 3)):
        kw = dict(vocab=512, seq_len=10, global_batch=2, seed=seed,
                  enc_len=6, d_model=8, vision_len=vision)
        got = pipeline.host_batch(pipeline.DataConfig(**kw), step)
        want = jpipe.host_batch(jpipe.DataConfig(**kw), step)
        assert sorted(got) == sorted(want)
        assert ("vision_embeds" in got) == bool(vision)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["enc_frames"].shape == (2, 6, 8)


@pytest.fixture(scope="module")
def grads_run():
    """The f32 loss and gradients on both sides, the port's under remat
    "none" and "unit"."""
    cj, ct = _pair("f32")
    params, model = _lm(cj, ct, seed=3)
    b = _batch(3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, cj, jb), has_aux=True))(params)
    out = {}
    for remat in ("none", "unit"):
        model.cfg = dataclasses.replace(ct, remat=remat)
        out[remat] = _loss_and_grads(model, b)
    return float(want), lm_state_from_jax(jax.tree.map(np.asarray, want_g)), \
        out, (cj, ct, params, b)


@pytest.mark.parametrize("remat", ["none", "unit"])
def test_lm_loss_and_gradients_match_jax(grads_run, remat):
    """f32 with frames: the loss within 1e-5 relative, each gradient
    within 1e-4 of its leaf's largest, the encoder's (its blocks, final
    norm and positions) and the K/V projection's among them; xattn's wk
    and wv are read by no one: the reference's gradients there are exact
    zeros and the port's are absent (the train step makes them zeros)."""
    want, want_g, out, _ = grads_run
    loss, _, grads = out[remat]
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    assert grads.keys() == want_g.keys()
    enc = [n for n in grads if n.startswith(("encoder.", "enc_kv_proj."))]
    assert len(enc) == 2 * 12 + 3 + 2
    for n, w in want_g.items():
        if n.endswith(UNREAD):
            assert grads[n] is None and not _np(w).any(), n
            continue
        _close(grads[n], w, LOGITS_TOL, n)
        assert np.abs(_np(grads[n])).max() > 0, n
    if remat == "unit":
        for n, g in grads.items():
            if g is not None:
                _close(g, out["none"][2][n], 1e-6, f"unit {n}")


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _first_step_direction(g, norm, cfg):
    g = g.astype(np.float64) * min(cfg.grad_clip / float(norm), 1.0)
    return g / (np.abs(g) + cfg.eps)


def test_train_step_matches_jax(grads_run):
    """One ``build_train_step`` step on a batch with frames against the
    reference's: AdamW decays the leaves the reference's mask decays;
    loss 1e-5 relative, grad_norm and lr 1e-6, each parameter within
    1e-5 of its leaf's largest plus twice the step noise its two
    gradients predict (tests/test_torch_lm_attn.py); xattn's wk and wv
    move by the decay alone, as the reference's."""
    _, gj, out, (cj, ct, params, b) = grads_run
    _, model = _lm(cj, ct, seed=3)
    want_decay = {
        "/".join(str(p.key) for p in path):
            jadamw._decay_mask(path) and a.ndim >= 2
        for path, a in jax.tree_util.tree_leaves_with_path(params)}
    got_decay = {"/".join(p for p in n.split(".") if not p.isdigit()):
                 decays(n, p) for n, p in model.named_parameters()}
    assert got_decay == want_decay
    ocfg = AdamWConfig(**OPT)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    gt = out["none"][2]
    jstate = {"params": params,
              "opt": jadamw.adamw_init(jadamw.AdamWConfig(**OPT), params)}
    jstate, want = jax.jit(jstep.build_train_step(
        cj, jadamw.AdamWConfig(**OPT)))(jstate, jb)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = tstep.init_train_state(model, ocfg)
    state, got = tstep.build_train_step(model, ocfg)(
        state, {k: _t(v) for k, v in b.items()})
    for k, tol in (("loss", 1e-5), ("grad_norm", 1e-6), ("lr", 1e-6)):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=tol,
                                   err_msg=k)
    lr = float(want["lr"])
    for n, w in lm_state_from_jax(jax.tree.map(
            np.asarray, jstate["params"])).items():
        w = _np(w)
        g = np.zeros_like(w) if gt[n] is None else _np(gt[n])
        noise = lr * np.abs(
            _first_step_direction(g, got["grad_norm"], ocfg)
            - _first_step_direction(_np(gj[n]), want["grad_norm"], ocfg))
        diff = np.abs(_np(state["params"][n]) - w)
        assert (diff <= 1e-5 * np.abs(w).max() + 2 * noise).all(), n
        if n.endswith(UNREAD):
            assert torch.allclose(state["params"][n],
                                  before[n] * (1 - lr * ocfg.weight_decay))
    assert state["opt"]["m"]["stages.s0_xattn.0.0.xattn.wk"].abs().max() == 0


def test_train_launcher_trains_whisper_on_the_cpu(tmp_path, capsys):
    """``launch/train.py --arch whisper-base --reduced --device cpu``:
    the batches carry enc_len frames, the losses are finite."""
    from repro_torch.launch import train as ltrain

    tr = ltrain.main(["--arch", "whisper-base", "--reduced", "--device",
                      "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
                      "--ckpt-dir", str(tmp_path)])
    assert "whisper-reduced on cpu" in capsys.readouterr().out
    assert tr.data_cfg.enc_len == T and tr.data_cfg.vision_len == 0
    assert tr.step == 2 and all(map(np.isfinite, tr.history))


# ---------------------------------------------------------------------------
# Serving, config, counts.
# ---------------------------------------------------------------------------

def test_engine_and_launcher_refuse_whisper(capsys):
    """The engine carries no audio frames: it refuses an encoder-decoder
    model at construction (the reference's engine would decode without
    cross-attention), and launch/serve.py refuses its --arch."""
    from repro_torch.launch import serve as lserve

    _, ct = _pair()
    with pytest.raises(ValueError, match="engine carries no audio frames"):
        ServeEngine(lm.LM(ct, device="cpu"), batch_size=2, max_len=32)
    with pytest.raises(SystemExit):
        lserve.main(["--arch", "whisper-base", "--reduced", "--device",
                     "cpu"])
    assert "engine carries no audio frames" in capsys.readouterr().err


def test_config_and_entry_match_the_reference():
    for make in ("full", "reduced"):
        mine, theirs = getattr(twh, make)(), getattr(jwh, make)()
        for f in dataclasses.fields(mine):
            if f.name == "gspn_impl":
                continue
            want, got = getattr(theirs, f.name), getattr(mine, f.name)
            if isinstance(got, torch.dtype):
                want = getattr(torch, str(jnp.dtype(want)))
            assert got == want, (make, f.name)
    a, b = tbase.get_arch("whisper-base"), jbase.get_arch("whisper-base")
    assert (a.name, a.family, a.skip_shapes, a.source) == \
        (b.name, b.family, b.skip_shapes, b.source)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_full_config_has_the_reference_counts(device):
    """98 505 728 parameters, on meta and drawn on the CPU, 78 275 584
    active (the encoder uncounted, as in the reference); its 39 leaves
    map one to one."""
    cfg = twh.full()
    threads = torch.get_num_threads()
    torch.set_num_threads(4)             # 98.5 M draws on the CPU
    try:
        model = lm.LM(cfg, device=device)
    finally:
        torch.set_num_threads(threads)
    assert lm.count_params(model) == 98_505_728
    assert lm.count_active_params(cfg) == \
        jlm.count_active_params(jwh.full()) == 78_275_584
    if device == "meta":
        shapes = jax.eval_shape(lambda k: jlm.init_lm(k, jwh.full()),
                                jax.random.PRNGKey(0))
        assert len(jax.tree.leaves(shapes)) == 39
        assert len(dict(model.named_parameters())) == 39 + 5 * (12 + 18)
