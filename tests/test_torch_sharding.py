"""The port's sharding rules against the JAX package's: the eight tests
of `tests/test_sharding.py` on the same duck meshes, and every ParamDef
leaf of the ten archs (parameters, optimizer state, caches, step inputs)
under every recipe on both production meshes: the port's spec equals the
reference's ``PartitionSpec`` entry for entry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.sharding import (make_rules,  # noqa: E402
                                              shard, use_rules)
from repro_torch.models.layers import ParamDef  # noqa: E402


class DuckMesh:
    """Duck-typed mesh for spec-resolution unit tests (no devices): what
    the port's rules read of a ``DeviceMesh``."""

    def __init__(self, shape, axes):
        self.mesh_dim_names = axes
        self.shape = shape


def test_divisible_dims_get_sharded():
    rules = make_rules("tp", DuckMesh((16, 16), ("data", "model")))
    assert rules.spec(("d_model", "d_ff"), (4096, 12288)) == (None, "model")


def test_non_divisible_dim_falls_back_to_none():
    rules = make_rules("tp", DuckMesh((16, 16), ("data", "model")))
    # 24 heads % 16 != 0 -> unsharded
    assert rules.spec(("heads",), (24,)) == (None,)
    assert not rules.dim_shardable("heads", 24)
    assert rules.dim_shardable("heads", 32)


def test_batch_prefix_fallback_multipod():
    rules = make_rules("tp", DuckMesh((2, 16, 16),
                                      ("pod", "data", "model")))
    # batch 256 divides pod*data=32 -> both axes
    assert rules.spec(("act_batch",), (256,)) == (("pod", "data"),)
    # batch 2 divides pod=2 only -> prefix fallback
    assert rules.spec(("act_batch",), (2,)) == ("pod",)
    # batch 1 -> replicated
    assert rules.spec(("act_batch",), (1,)) == (None,)


def test_mesh_axis_never_assigned_twice():
    rules = make_rules("tp", DuckMesh((16, 16), ("data", "model")))
    # experts=16 takes 'model'; moe_ff must NOT also take it
    assert rules.spec(("experts", "d_model", "moe_ff"),
                      (16, 1536, 512)) == ("model", None, None)
    # experts=40 fails -> moe_ff picks up 'model'
    assert rules.spec(("experts", "d_model", "moe_ff"),
                      (40, 1536, 512)) == (None, None, "model")


def test_fsdp_shards_weight_dmodel_on_data():
    rules = make_rules("fsdp_tp", DuckMesh((16, 16), ("data", "model")))
    assert rules.spec(("d_model", "heads", "head_dim"),
                      (16384, 128, 128)) == ("data", "model", None)


def test_param_specs_tree():
    rules = make_rules("tp", DuckMesh((1, 1), ("data", "model")))
    defs = {"w": ParamDef((64, 128), ("d_model", "d_ff"))}
    # 1-device mesh: nothing sharded
    assert rules.param_specs(defs)["w"] == (None, None)


def test_shard_noop_without_rules():
    x = torch.ones((4, 4))
    assert shard(x, "act_batch", None) is x


def test_shard_constraint_applies_in_context():
    rules = make_rules("tp", DuckMesh((1, 1), ("data", "model")))
    with use_rules(rules):
        x = shard(torch.ones((4, 4)), "act_batch", None)
    assert x.shape == (4, 4)


def test_placements_put_a_tuple_entry_on_every_named_mesh_dim():
    """("pod", "data") on one tensor dim: ``Shard`` of that dim on both
    mesh dims, the rest ``Replicate``; a one-name entry on its own."""
    from torch.distributed.tensor import Replicate, Shard
    rules = make_rules("tp", DuckMesh((2, 16, 16),
                                      ("pod", "data", "model")))
    assert rules.placements(("act_batch", None, "act_vocab"),
                            (256, 8, 151936)) == (Shard(0), Shard(0),
                                                  Shard(2))
    assert rules.placements(("act_batch", "act_heads"), (1, 24)) == (
        Replicate(),) * 3


# ---------------------------------------------------------------------------
# Every leaf of every arch against the reference
# ---------------------------------------------------------------------------

ARCHS = ["phi3.5-moe-42b-a6.6b", "granite-moe-3b-a800m", "qwen3-8b",
         "starcoder2-3b", "h2o-danube-3-4b", "llama3-405b",
         "musicgen-medium", "jamba-v0.1-52b", "xlstm-350m",
         "phi-3-vision-4.2b"]
RECIPES = ["dp", "tp", "fsdp_tp", "decode_2d"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _leaf_trees(mods, cfg):
    """Named ParamDef trees of one arch: params, AdamW state, the decode
    caches and each applicable shape's step inputs."""
    trees = {"params": mods.model_defs(cfg),
             "opt": mods.adamw_init_defs(mods.model_defs(cfg))}
    for shape in mods.applicable_shapes(cfg):
        trees[f"inputs/{shape.name}"] = mods.input_defs(cfg, shape)
        if shape.mode != "train":
            trees[f"cache/{shape.name}"] = mods.cache_defs(
                cfg, shape.global_batch, shape.seq_len)
    return trees


class _Mods:
    def __init__(self, configs, model, adamw):
        self.get_config = configs.get_config
        self.applicable_shapes = configs.applicable_shapes
        self.model_defs = model.model_defs
        self.input_defs = model.input_defs
        self.cache_defs = model.cache_defs
        self.adamw_init_defs = adamw.adamw_init_defs


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_spec_matches_reference(arch, recipe, mesh):
    jax = pytest.importorskip("jax")
    from repro import configs as jcfg
    from repro.distributed.sharding import make_rules as jmake_rules
    from repro.models import layers as JL
    from repro.models import model as JM
    from repro.optim import adamw as JA
    from repro_torch import configs as tcfg
    from repro_torch.models import layers as TL
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw as TA

    shape, axes = MESHES[mesh]

    class JaxDuckMesh:  # the reference test's FakeMesh
        axis_names = axes
        devices = np.empty(shape, dtype=object)

    jr = jmake_rules(recipe, JaxDuckMesh())
    tr = make_rules(recipe, DuckMesh(shape, axes))
    jm, tm = _Mods(jcfg, JM, JA), _Mods(tcfg, TM, TA)
    jtrees = _leaf_trees(jm, jm.get_config(arch))
    ttrees = _leaf_trees(tm, tm.get_config(arch))
    assert list(jtrees) == list(ttrees)
    n = 0
    for name in jtrees:
        # by path: jax orders dict keys, the port keeps insertion order
        jleaves = {jax.tree_util.keystr(p): d for p, d in
                   jax.tree_util.tree_flatten_with_path(
                       jtrees[name], is_leaf=JL.is_def)[0]}
        tleaves = dict(TL.tree_leaves_with_path(ttrees[name], TL.is_def))
        assert sorted(jleaves) == sorted(tleaves), name
        for path, td in tleaves.items():
            jd = jleaves[path]
            assert (tuple(jd.shape), tuple(jd.axes)) == (td.shape, td.axes)
            want = tuple(jr.spec(jd.axes, jd.shape))
            assert tr.spec(td.axes, td.shape) == want, (name, path)
            n += 1
    assert n > 0
