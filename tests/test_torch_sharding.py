"""``lc2is_tpu_torch/parallel/sharding.py`` against
``lc2is_tpu/parallel/sharding.py``:

- every parameter's spec of all 13 zoo models at full width (the port's
  models on the meta device, JAX's trees from ``jax.eval_shape``, so nothing
  compiles) equal to JAX's ``infer_param_specs`` on model axes of 2 and 4
  (and 1, 3: every dim divides 1, few divide 3), and the census equal;
- ``infer_opt_specs`` of an AdamW state against JAX's of an optax
  ``adamw`` state for the same model;
- the port mesh's rank layout against JAX ``make_mesh(...).devices``;
- ``shard`` round trips for both specs, the shards put back together here
  (the gather over processes is ``tests/test_torch_tp.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from lc2is_tpu.core.mesh import make_mesh as jax_make_mesh
from lc2is_tpu.engine.optim import make_optimizer as jax_make_optimizer
from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.parallel import sharding as JS
from lc2is_tpu_torch.core import mesh as M
from lc2is_tpu_torch.core.convert import seeded_init_, torch_key
from lc2is_tpu_torch.engine.optim import make_optimizer
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.parallel import sharding as S

V1 = ("base_with_text", "contrastive", "dense_clip")
TEXT = V1 + ("prompt_ftn_v1", "prompt_ftn")
SPEC = {P(): S.REPLICATED, P(JS.MODEL_AXIS, None): S.COLUMN, P(None, JS.MODEL_AXIS): S.ROW}


def _kwargs(key):
    """Each package's constructor arguments: the defaults, but the v1 models'
    label size, which their pixel decoder takes as 4 x in_size / patch (the
    CLI's 512 -> 128)."""
    return dict(in_size=224, out_size=56) if key in V1 else {}


def _jax_shapes(key):
    """The JAX model's full-width parameter tree, shapes only."""
    size = 512 if key in ("base_ftn", "prompt_ftn") else 224 if key in V1 else 64
    inputs = {"pixel_values": jax.ShapeDtypeStruct((1, 3, size, size), jnp.float32)}
    if key in TEXT:
        inputs.update(input_ids=jax.ShapeDtypeStruct((2, 77), jnp.int32),
                      attention_mask=jax.ShapeDtypeStruct((2, 77), jnp.int32))
    return jax.eval_shape(jzoo.ZOO[key](**_kwargs(key)).init, jax.random.PRNGKey(0),
                          inputs)["params"]


def _port_name(jax_name: str) -> str:
    return torch_key(tuple(jax_name.split(".")))


def _jax_mesh(m):
    return jax_make_mesh(data=8 // m if 8 % m == 0 else 1, model=m,
                         devices=jax.devices()[:8 if 8 % m == 0 else m])


@pytest.mark.parametrize("key", sorted(jzoo.ZOO))
def test_specs_and_census_match_jax(key):
    shapes = _jax_shapes(key)
    port = zoo.ZOO[key](device="meta", **_kwargs(key))
    sharded = 0
    for m in (1, 2, 3, 4):
        mesh = _jax_mesh(m)
        flat = jax.tree_util.tree_flatten_with_path(JS.infer_param_specs(shapes, mesh),
                                                    is_leaf=lambda x: isinstance(x, P))[0]
        want = {_port_name(JS._path_str(path)): SPEC[spec] for path, spec in flat}
        got = S.infer_param_specs(port, m)
        assert got == want, (m, {k: (got.get(k), v) for k, v in want.items()
                                 if got.get(k) != v})
        sharded = max(sharded, sum(s != S.REPLICATED for s in got.values()))
        census = JS.spec_census(shapes, mesh)
        want_census = {k: sorted((_port_name(n[0]), n[1]) if isinstance(n, tuple)
                                 else _port_name(n) for n in v) for k, v in census.items()}
        got_census = {k: sorted(v) for k, v in S.spec_census(port, m).items()}
        assert got_census == want_census, m
    assert sharded > 0  # the rules matched the port's names


def test_rules_read_the_flax_path():
    """The rules see the flax path (swin's ``self`` is flax's ``self_``, a
    list element ``layers.0`` is ``layers_0``), and split only 2-D weights
    whose dim the axis divides."""
    assert S.rule_name("backbone.encoder.layers.0.blocks.1.attention.self.query.weight") == \
        "backbone.encoder.layers_0.blocks_1.attention.self_.query.weight"
    assert S.spec_of("x.attention.self.query.weight", (8, 4), 2) == S.COLUMN
    assert S.spec_of("x.attention.output.dense.weight", (4, 8), 2) == S.ROW
    assert S.spec_of("text_encoder.token_embedding.weight", (10, 8), 2) == S.ROW
    assert S.spec_of("x.linear1.weight", (9, 8), 2) == S.REPLICATED  # 9 rows: indivisible
    assert S.spec_of("x.linear1.bias", (8,), 2) == S.REPLICATED
    assert S.spec_of("x.linear1.weight", (8, 8), 1) == S.REPLICATED


def test_opt_specs_match_jax():
    """The AdamW moments inherit their parameter's spec, the step counts are
    replicated, as JAX's ``infer_opt_specs`` of optax's adamw state."""
    key = "base_cross_a"
    shapes = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), _jax_shapes(key))
    mesh = _jax_mesh(2)
    jspecs = JS.infer_param_specs(shapes, mesh)
    tx = jax_make_optimizer(shapes)
    opt_state = tx.init(shapes)
    jopt = JS.infer_opt_specs(opt_state, shapes, jspecs)
    mu = None
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jopt, is_leaf=lambda x: isinstance(x, P))[0]:
        names = [getattr(k, "name", None) for k in path]
        if "mu" in names:
            mu = mu or {}
            keys = [str(k.key) for k in path if hasattr(k, "key")]
            mu[_port_name(".".join(keys))] = SPEC[spec]
    assert mu, "no adamw moments found in the optax state"
    model = zoo.ZOO[key](device="cpu")
    opt = make_optimizer(model)
    for p in opt.params:
        p.grad = torch.zeros_like(p)
    opt.step()
    specs = S.infer_param_specs(model, 2)
    got = S.infer_opt_specs(opt.adamw.state_dict(), opt.names, specs)
    for i, name in enumerate(opt.names):
        assert got[i] == {"step": S.REPLICATED, "exp_avg": mu[name], "exp_avg_sq": mu[name]}, \
            name


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (4, 2), (2, 4), (1, 8), (8, 1)])
def test_rank_layout_matches_jax(data, model):
    """Rank r sits where JAX's mesh puts device r, (r // model, r % model),
    and loads its data index's rows."""
    devices = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model]).devices
    for i in range(data):
        for j in range(model):
            mesh = M.Mesh(data, model, devices[i, j].id, torch.device("cpu"))
            assert (mesh.data_index, mesh.model_index) == (i, j)
            assert M.batch_rows(mesh, 8 * data).start == 8 * i


def _unshard(parts, spec):
    """The whole tensor of its shards (in model-index order)."""
    if spec == S.REPLICATED or len(parts) == 1:
        return parts[0]
    return torch.cat(list(parts), dim=spec.index(M.MODEL_AXIS))


@pytest.mark.parametrize("spec", [S.COLUMN, S.ROW, S.REPLICATED])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_shard_unshard_round_trip(spec, m):
    t = torch.from_numpy(np.random.RandomState(0).randn(8, 12).astype(np.float32))
    parts = [S.shard(t, spec, i, m) for i in range(m)]
    if spec != S.REPLICATED and m > 1:
        d = spec.index(M.MODEL_AXIS)
        assert all(p.shape[d] == t.shape[d] // m and p.is_contiguous() for p in parts)
        assert all(p.data_ptr() != t.data_ptr() for p in parts)  # copies, not views
        torch.testing.assert_close(parts[1], t.chunk(m, dim=d)[1], rtol=0, atol=0)
    assert torch.equal(_unshard(parts, spec), t)


def test_shard_params_cuts_each_rank_its_shard():
    """``shard_params`` of a module: each rank of a model axis of 2 its half
    of every sharded weight (by its model index), the rest whole."""
    model = zoo.BaseCrossA(class_names=("a", "b"), swin_cfg=dict(
        embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window=4),
        dec_dim=32, nhead=4, device="cpu")
    seeded_init_(model, 0)
    whole = dict(model.named_parameters())
    parts = [S.shard_params(model, M.Mesh(1, 2, r, torch.device("cpu"))) for r in (0, 1)]
    specs = parts[0][1]
    assert specs == S.infer_param_specs(model, 2) and {S.COLUMN, S.ROW} <= set(specs.values())
    for name, t in whole.items():
        got = [p[0][name] for p in parts]
        assert torch.equal(_unshard(got, specs[name]), t.detach()), name
        if specs[name] == S.REPLICATED:
            assert all(g.shape == t.shape for g in got)
        else:
            assert all(g.numel() * 2 == t.numel() for g in got)
