"""Spec-space conformance of the port (DESIGN.md §11, §14): every spec of
``repro_torch.kernels.spec.enumerate_specs`` that runs on the CPU goes
through its entry against the JAX reference.

* ``torch`` specs (fwd, pair_fwd): forward and gradient against the
  reference's ``impl="xla"`` leg through the same entry
  (``directional_scan`` for fwd, with the spatial orientation cycled as the
  reference's grid cycles it; ``gspn_scan_pair`` for pair_fwd);
* ``quad`` specs (forward only, kernel leg only, as in the reference): the
  wrapper, which takes its plain version for CPU tensors, against the
  reference's quad oracle, and one small shape against
  ``gspn_scan_quad_pallas`` in interpret mode.

Inputs come from numpy with a seed.  bfloat16 specs round the inputs to
bfloat16 once and hold the port, which computes in f32 and rounds its
output once (DESIGN.md §10), against the reference in f32 on those same
values: 1e-2 for outputs; 3e-2 for gradients, which carry three bfloat16
roundings of 2^-8 each (the cotangent reaching the bfloat16 output, the
saved output the epilogue reads, the stored gradient) before a sum over
each weight group.  float32: 1e-5, forward and gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gspn as jgspn
from repro.kernels import gspn_multidir as jmk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import spec as jspec
from repro_torch.core import gspn
from repro_torch.kernels import gspn_multidir, ops
from repro_torch.kernels.spec import enumerate_specs

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SINGLE_DIRS = ["tb", "bt", "lr", "rl"]
BASE_SHAPES = {"fwd": (12, 8), "pair_fwd": (12, 8), "quad": (12, 12)}
N_DIRS = {"fwd": 1, "pair_fwd": 2, "quad": 4}

SPECS = enumerate_specs()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps torch from competing with
    the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases():
    """(spec, orientation) for every spec that runs on the CPU; the
    orientation cycles over the fwd specs as in the reference's grid."""
    return [(sp, SINGLE_DIRS[i % 4] if sp.direction == "fwd" else None)
            for i, sp in enumerate(SPECS)
            if sp.impl == "torch" or sp.direction == "quad"]


CASES = _cases()


def _case_id(case):
    sp, ori = case
    return (f"{sp.canonical()}-cpw{sp.channels_per_weight}-"
            f"{ori or sp.direction}").replace("|", "_")


def _operands(sp, seed):
    """(x, wl, wc, wr, lam) and the cotangent, in the spec's stream dtype
    for the port and as float32 numpy arrays of the same values for the
    reference.  lam and the cotangent are stacked per direction with
    signs and scales that differ, as the reference's grid stacks them."""
    h, w = BASE_SHAPES[sp.direction]
    nd = N_DIRS[sp.direction]
    cpw = sp.channels_per_weight
    c, gw = 2 * cpw, 2
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, h, w))
    lam = 1.0 / (1.0 + np.exp(-rng.standard_normal((c, h, w))))
    z = rng.standard_normal(((nd,) if nd > 1 else ()) + (gw, h, w, 3))
    z = np.exp(z - z.max(-1, keepdims=True))
    z /= z.sum(-1, keepdims=True)
    dy = rng.standard_normal((c, h, w))
    lam = {1: lam, 2: np.stack([lam, -lam]),
           4: np.stack([lam, -lam, 2 * lam, lam])}[nd]
    cot = dy if nd == 1 else np.stack([dy, -dy])
    stream = getattr(torch, sp.stream_dtype)
    port = tuple(torch.from_numpy(a.astype(np.float32)).to(stream)
                 for a in (x, z[..., 0], z[..., 1], z[..., 2], lam))
    ref = tuple(t.float().numpy() for t in port)
    return port, ref, cot.astype(np.float32)


def _close(got, want, dtype, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol[dtype], atol=tol[dtype])


def _jax_quad_oracle(x, wl4, wc4, wr4, lam4):
    """The reference's quad semantics (``tests/test_conformance.py``)."""
    xt = jnp.swapaxes(x, -1, -2)
    return jnp.stack([jref.gspn_scan_ref(
        x if d < 2 else xt, wl4[d], wc4[d], wr4[d], lam4[d],
        reverse=d % 2 == 1) for d in range(4)])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_spec_grid_conformance(case):
    sp, ori = case
    port, ref, cot = _operands(sp, CASES.index(case))
    dtype = sp.stream_dtype
    jargs = tuple(jnp.asarray(a) for a in ref)
    if sp.direction == "quad":
        _close(gspn_multidir.gspn_scan_quad(*port),
               _jax_quad_oracle(*jargs), dtype)
        return

    jsp = jspec.ScanSpec(direction=sp.direction, impl="xla",
                         channels_per_weight=sp.channels_per_weight)
    if sp.direction == "fwd":
        def mine(*a):
            return gspn.directional_scan(*a, ori, spec=sp)

        def theirs(*a):
            return jgspn.directional_scan(*a, ori, spec=jsp)
    else:
        def mine(*a):
            return ops.gspn_scan_pair(*a, spec=sp)

        def theirs(*a):
            return jops.gspn_scan_pair(*a, spec=jsp)

    leaves = [t.clone().requires_grad_(True) for t in port]
    out = mine(*leaves)
    assert out.dtype == port[0].dtype
    _close(out, theirs(*jargs), dtype)
    got = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(),
                              leaves)
    want = jax.grad(lambda *a: jnp.sum(theirs(*a) * cot),
                    argnums=tuple(range(5)))(*jargs)
    for g, w in zip(got, want):
        assert g.dtype == port[0].dtype
        _close(g, w, dtype, GRAD_TOL)


def test_quad_spec_entry_matches_pallas_interpret():
    sp = next(s for s in SPECS if s.direction == "quad"
              and s.stream_dtype == "float32" and s.channel_shared)
    port, ref, _ = _operands(sp, 99)
    x, wl4, wc4, wr4, lam4 = (jnp.asarray(a) for a in ref)
    want = jmk.gspn_scan_quad_pallas(
        x, {"wl": wl4, "wc": wc4, "wr": wr4}, lam4,
        channels_per_weight=sp.channels_per_weight, row_tile=4)
    _close(gspn_multidir.gspn_scan_quad(*port), want, "float32")


def test_grid_is_the_reference_grid_mapped():
    """The port's grid is the reference's with the kernel legs
    (``pallas``, ``multidir``) named ``cuda`` and ``xla`` named ``torch``,
    less the narrow-carry legs the port refuses and the TPU pipeline
    depths it has no counterpart for; nothing else."""
    legs = {"pallas": "cuda", "multidir": "cuda", "xla": "torch"}
    theirs = {(s.direction, legs[s.impl], s.channels_per_weight,
               s.stream_dtype, s.carry_dtype, s.boundary)
              for s in jspec.enumerate_specs() if s.carry_dtype == "float32"}
    mine = [(s.direction, s.impl, s.channels_per_weight, s.stream_dtype,
             s.carry_dtype, s.boundary) for s in SPECS]
    assert len(mine) == len(set(mine)) == len(SPECS)
    assert set(mine) == theirs
    by_key = {(s.direction, s.impl, s.channels_per_weight, s.stream_dtype):
              s for s in SPECS}
    for s in jspec.enumerate_specs():
        if s.carry_dtype != "float32":
            continue
        m = by_key[s.direction, legs[s.impl], s.channels_per_weight,
                   s.stream_dtype]
        assert m.canonical() == s.canonical().replace(
            f"|{s.impl}|", f"|{legs[s.impl]}|")
