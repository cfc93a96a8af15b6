"""The arithmetic of the bf16 tensor-core bodies of the two forward kernels,
emulated step by step on the CPU and held against lc2is_tpu's Pallas kernels
in interpret mode (as the JAX package's own tests run them) and against the
port's plain versions, on the same numpy-seeded inputs.  The same emulation
with no rounding stands for the f32 bodies' algorithm.

Row 2, ``fused_attn_block`` (``lc2is_tpu_torch/csrc/attention_block.cu`` on
``csrc/attn_block_fwd.cuh``, the forward that row 3's backward recomputes):
q = round(x · wqᵀ + bq) with 1/√dh folded into wq and bq in f32 and then
rounded; per head the online softmax over 64-key tiles, p rounded per tile
before P · V while l sums the unrounded p, att = round(acc / l); s = att ·
woᵀ + bo + x in f32; out = round(LN(s)) with f32 statistics.  The C x C
products sum 32-wide k-slices, as the GEMM's ring does
(``tests/test_torch_block_tiles.py::tiled_attn_block_fwd``).

Row 1, ``fused_mlp`` (``csrc/fused_mlp.cu``: two products on the GEMM of
``csrc/gemm_bf16.cuh``): pre h = round(LN(x)), post h = x; upre = h · w1ᵀ +
b1 in f32, written rounded; u = round(act(upre)) (the polynomial gelu in
bf16, erf-gelu in f32, or relu); y = u · w2ᵀ + b2 in f32; pre out = round(y
[+ x]), post out = round(LN(y [+ x])).  Biases and LN weights are the
working dtype's values added in f32.

Stated tolerances, as for the row-3 and row-6 emulations: f32 2e-4
absolute and relative (the sums run in other orders; JAX's f32 gelu is a
rational erf within 2e-5 of the exact one); bf16 |Δ| ≤ 5e-2 + 2e-2·|ref|
against the plain version and the Pallas kernel, the card gate of phase 3
(one bf16 step of an O(1) output is 2^-8 relative, and the emulation rounds
where the kernels round while the Pallas kernel normalises p before
rounding it).  A control that must fail: the attention over all keys but
the last 64-key tile.

Every ``extern "C"`` declaration of ``csrc/`` is held against the argtypes
``ops/_build.py`` binds; the int8 row's entry points also by name (the
workspace after the output), and its wrappers' card path, with the launch
recorded on CPU tensors, against those argtypes.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lc2is_tpu.ops import attention_block as jab
from lc2is_tpu.ops import fused_mlp as jmlp
from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.attention_block import fused_attn_block_plain
from lc2is_tpu_torch.ops.fused_mlp import _act, _act_name, fused_mlp_plain
from test_torch_block_tiles import _attn_inputs, _mm, _round, tiled_attn_block_fwd

TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4), torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
CSRC = Path(__file__).resolve().parents[1] / "lc2is_tpu_torch" / "csrc"


def _close(got, want, dtype, what):
    want = torch.from_numpy(np.array(want, np.float32))
    assert torch.isfinite(got).all(), what
    torch.testing.assert_close(got.float(), want, **TOL[dtype], msg=lambda m: f"{what}: {m}")


def _ln(v, w, b, eps=1e-5):
    """LayerNorm with two-pass f32 statistics, as layer_norm.cuh takes them."""
    mu = v.mean(-1, keepdim=True)
    rs = torch.rsqrt(((v - mu) ** 2).mean(-1, keepdim=True) + eps)
    return (v - mu) * rs * w + b


# ---------------------------------------------------------------------------
# row 2: the decoder attention block's forward
# ---------------------------------------------------------------------------


def tiled_attn_block(x, k, v, wq, bq, wo, bo, lnw, lnb, heads, dtype, eps=1e-5):
    """Row 2's bf16 body (identity rounding for f32) on f32 tensors holding
    dtype activations and f32 weights (wq, bq unscaled)."""
    sf = tiled_attn_block_fwd(x, k, v, wq, bq, wo, bo, heads, dtype)[3]
    return _round(_ln(sf, _round(lnw, dtype), _round(lnb, dtype), eps), dtype)


def _pallas_attn(args, heads, jdt):
    arrs = [jnp.asarray(a).astype(jdt) if i < 3 else jnp.asarray(a) for i, a in enumerate(args)]
    return np.array(jab.fused_attn_block(*arrs, heads, interpret=True).astype(jnp.float32))


def _plain_attn(args, heads, dtype):
    t = [torch.from_numpy(a).to(dtype) if i < 3 else torch.from_numpy(a)
         for i, a in enumerate(args)]
    return fused_attn_block_plain(*t, heads).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,l,c,heads", [
    (65, 151, 64, 4),   # dh 16, ragged P, the class count as L
    (130, 7, 64, 2),    # dh 32, P past two query tiles, one ragged key tile
    (63, 1, 64, 1),     # dh 64, one key
    (129, 65, 128, 2),  # dh 64, L one past a key tile
    (100, 64, 128, 8),  # dh 16 at 8 heads, L one whole key tile
])
def test_tiled_attn_block_matches_pallas_and_plain(dtype, p, l, c, heads):
    """Row 2's emulation against the Pallas kernel (interpret mode) and
    fused_attn_block_plain on the same inputs."""
    tdt = getattr(torch, dtype)
    args, _ = _attn_inputs(7 * p + l + c + heads, 2, p, l, c, tdt)
    t = [torch.from_numpy(a) for a in args]
    got = tiled_attn_block(*t, heads, tdt)
    _close(got, _pallas_attn(args, heads, getattr(jnp, dtype)), tdt, "Pallas")
    _close(got, _plain_attn(args, heads, tdt), tdt, "plain")


def test_tiled_attn_block_control_drops_a_key_tile():
    """The control that must fail: the bf16 emulation over all keys but the
    last 64-key tile (L = 151: keys 0-127) is outside the bf16 bound of the
    Pallas kernel's output."""
    args, _ = _attn_inputs(11, 2, 70, 151, 128, torch.bfloat16)
    t = [torch.from_numpy(a) for a in args]
    short = [t[0], t[1][:, :128], t[2][:, :128]] + t[3:]
    got = tiled_attn_block(*short, 2, torch.bfloat16)
    with pytest.raises(AssertionError):
        _close(got, _pallas_attn(args, 2, jnp.bfloat16), torch.bfloat16, "Pallas")


# ---------------------------------------------------------------------------
# row 1: the feed-forward
# ---------------------------------------------------------------------------


def tiled_fused_mlp(x, lnw, lnb, w1, b1, w2, b2, activation, pre, residual, dtype, eps=1e-5):
    """Row 1's bf16 body (identity rounding for f32): (out, upre rounded) on
    an f32 (T, C) tensor holding dtype values and f32 weights."""
    lnw, lnb, w1, b1, w2, b2 = (_round(t, dtype) for t in (lnw, lnb, w1, b1, w2, b2))
    h = _round(_ln(x, lnw, lnb, eps), dtype) if pre else x
    upre = _mm(h, w1.t()) + b1
    u = _round(_act(_act_name(activation, dtype), upre), dtype)
    y = _mm(u, w2.t()) + b2
    if residual:
        y = y + x
    out = y if pre else _ln(y, lnw, lnb, eps)
    return _round(out, dtype), _round(upre, dtype)


def _mlp_inputs(seed, t, c, dtype):
    """numpy-seeded x (rounded through dtype) and f32 (ln_w, ln_b, w1, b1,
    w2, b2), F = 4C."""
    rs = np.random.RandomState(seed)
    f = 4 * c
    x = torch.from_numpy(rs.randn(t, c).astype(np.float32)).to(dtype).float().numpy()
    params = [1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c), rs.randn(f, c) / np.sqrt(c),
              0.1 * rs.randn(f), rs.randn(c, f) / np.sqrt(f), 0.1 * rs.randn(c)]
    return [x] + [a.astype(np.float32) for a in params]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,c,activation,pos,residual", [
    (200, 96, "gelu", "pre", True),    # swin stage 1's width, 200 rows: no multiple of 64
    (77, 128, "gelu", "pre", False),
    (130, 128, "relu", "post", True),  # the decoder layers' form
    (65, 96, "relu", "post", False),
    (129, 128, "relu", "pre", True),
    (191, 96, "gelu", "post", True),
])
def test_tiled_fused_mlp_matches_pallas_and_plain(dtype, t, c, activation, pos, residual):
    """Row 1's emulation against the Pallas kernel (interpret mode), its
    saved pre-activation (the training launch's upre) against the Pallas
    kernel's, and the output against fused_mlp_plain."""
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    args = _mlp_inputs(t + c + residual, t, c, tdt)
    kw = dict(activation=activation, ln_position=pos, residual=residual)
    got, upre = tiled_fused_mlp(*(torch.from_numpy(a) for a in args), activation, pos == "pre",
                                residual, tdt)
    jx = jnp.asarray(args[0]).astype(jdt)
    jw = [jnp.asarray(a) for a in args[1:]]
    want = jmlp.fused_mlp(jx, *jw, interpret=True, **kw)
    _close(got, want.astype(jnp.float32), tdt, "Pallas")
    _, jupre = jmlp._fwd_impl(jx, *jw, act=activation, pre=pos == "pre", residual=residual,
                              eps=1e-5, block_tokens=None, interpret=True, save_upre=True)
    _close(upre, jupre.astype(jnp.float32), tdt, "Pallas upre")
    plain = fused_mlp_plain(torch.from_numpy(args[0]).to(tdt),
                            *(torch.from_numpy(a) for a in args[1:]), **kw)
    _close(got, plain.float().numpy(), tdt, "plain")


# ---------------------------------------------------------------------------
# the C entry points the wrappers bind
# ---------------------------------------------------------------------------

_C_TYPES = {"void*": _build.ctypes.c_void_p, "int": _build.ctypes.c_int,
            "float": _build.ctypes.c_float}


def _entry_points():
    """{name: [ctypes type of each parameter]} of every extern "C" function
    in csrc/*.cu, read from the sources."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" (?:int|long long|const char\*) (\w+)\(([^)]*)\)', text):
            params = ["".join(re.sub(r"\bconst\b", "", a).split()).rsplit("*", 1)[0] + "*"
                      if "*" in a else a.split()[0] for a in m.group(2).split(",") if a.strip()]
            out[m.group(1)] = [_C_TYPES[p] for p in params]
    return out


def test_entry_point_signatures_match_the_sources():
    """Every argtypes list the build binds (``_build.SIGNATURES``,
    ``SIZE_SIGNATURES``) matches the extern "C" declaration in csrc/: the
    sources compile only on the card, and ctypes passes whatever it is told,
    so a count or type that drifts would shift every later argument."""
    found = _entry_points()
    for table in (_build.SIGNATURES, _build.SIZE_SIGNATURES):
        for name, argtypes in table.items():
            assert name in found, name
            assert found[name] == list(argtypes), name
    for name in ("lc2_attn_block_fwd_workspace_bf16", "lc2_fused_mlp_workspace_bf16"):
        assert name in _build.SIZE_SIGNATURES, name


@pytest.mark.parametrize("name,params", [
    ("lc2_fused_mlp_q", "ws"), ("lc2_attn_block_q", "ws"),
    ("lc2_fused_mlp_q_workspace_bf16", "n_tok, C, F, pre"),
    ("lc2_attn_block_q_workspace_bf16", "B, P, L, C, heads")])
def test_int8_entry_points_match_the_sources(name, params):
    """The int8 row's entry points, which its bf16 bodies changed (a
    workspace pointer after the output) or added (the workspace sizes), are
    bound with the argtypes of their extern "C" declarations, and take the
    named parameters."""
    found = _entry_points()
    table = _build.SIGNATURES if name in _build.SIGNATURES else _build.SIZE_SIGNATURES
    assert found[name] == list(table[name]), name
    decl = re.search(rf'extern "C" [^(]* {name}\(([^)]*)\)',
                     "".join(p.read_text() for p in CSRC.glob("*.cu"))).group(1)
    names = [a.split()[-1].lstrip("*") for a in decl.split(",")]
    for p in params.split(", "):
        assert p in names, (name, p)
    if "ws" in params:  # the workspace follows the output, as in lc2_attn_block
        assert names.index("ws") == names.index("out") + 1, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["fused_mlp_q", "fused_attn_block_q"])
def test_int8_wrappers_pass_their_signatures(monkeypatch, dtype, op):
    """The card path of each int8 wrapper, its launch replaced by a recorder
    on CPU tensors: the arguments it hands ctypes match the entry point's
    argtypes in count and kind, the bf16 body gets a workspace of the size
    entry's floats and its weights unquantised (it quantises them on the
    card), the f32 body no workspace and, in the feed-forward, its weights as
    panels."""
    from lc2is_tpu_torch.ops import attention_block, quant

    tdt = getattr(torch, dtype)
    calls, sizes, panels = [], [], []
    monkeypatch.setattr(_build, "launch", lambda name, dev, *a: calls.append((name, a)))
    monkeypatch.setattr(_build, "size", lambda name, *a: sizes.append(name) or 64)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    k_panels = quant.k_panels
    monkeypatch.setattr(quant, "k_panels", lambda q: panels.append(q.shape) or k_panels(q))
    mod = quant if op == "fused_mlp_q" else attention_block
    monkeypatch.setattr(mod, "use_kernel", lambda t: True)
    rs = np.random.RandomState(0)
    c = 128
    if op == "fused_mlp_q":
        x = torch.from_numpy(rs.randn(5, c).astype(np.float32)).to(tdt)
        w = [torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in ((c,), (c,), (4 * c, c), (4 * c,), (c, 4 * c), (c,))]
        with torch.no_grad():
            quant.fused_mlp_q(x, *w)
    else:
        x, k, v = (torch.from_numpy(rs.randn(2, n, c).astype(np.float32)).to(tdt)
                   for n in (7, 9, 9))
        w = [torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in ((c, c), (c,), (c, c), (c,), (c,), (c,))]
        with torch.no_grad():
            attention_block.fused_attn_block_q(x, k, v, *w, 4)
    (name, args), = calls
    kinds = {_build.ctypes.c_void_p: (int, type(None)), _build.ctypes.c_int: (int,),
             _build.ctypes.c_float: (float,)}
    argtypes = _build.SIGNATURES[name]
    assert len(args) == len(argtypes), name
    for a, t in zip(args, argtypes):
        assert isinstance(a, kinds[t]), (name, a, t)
    ws = args[13 if op == "fused_attn_block_q" else 11]
    if dtype == "bfloat16":
        assert ws is not None and sizes == [f"{name}_workspace_bf16"] and not panels
    else:
        assert ws is None and not sizes
        assert len(panels) == (2 if op == "fused_mlp_q" else 0)
