"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's: every case of tests/test_sharding_rules.py with the same
expected specs, and a property over random (axes, shape) pairs on the
1-pod and 2-pod production meshes under the default, decode, fsdp and
dponly tables: the port's ``spec_for`` equals the reference's on
``AbstractMesh``, and the local shapes DTensor gives on a ``fake`` mesh of
the same shape are the shard shapes the reference's spec implies."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import math

import torch.distributed as dist
from _hypothesis_compat import given, settings, strategies as st
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

try:
    from jax.sharding import AbstractMesh as JaxAbstractMesh, AxisType
except ImportError:  # older jax: no AbstractMesh/AxisType
    pytest.skip("jax.sharding lacks AbstractMesh/AxisType in this jax",
                allow_module_level=True)

from repro.sharding.rules import default_rules as jax_default_rules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (AbstractMesh, device_mesh, join_fake_group,
                                     production_mesh_shape, tiny_mesh_shape)
from repro_torch.sharding.rules import (DEFAULT_RULES, default_rules, local_shape,
                                        placements)

def _reference_profiles() -> dict:
    """``PROFILES`` of repro/launch/dryrun.py, read from its source: the
    module sets XLA_FLAGS to 512 host devices when imported."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1] / "src" / "repro" / "launch"
                      / "dryrun.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.AnnAssign)
                and getattr(n.target, "id", None) == "PROFILES")
    return ast.literal_eval(node.value)


JAX_PROFILES = _reference_profiles()
MESHES = {"1pod": production_mesh_shape(), "2pod": production_mesh_shape(multi_pod=True)}
RULES = default_rules()


def spec(axes, shape, mesh=None):
    return RULES.spec_for(axes, shape, mesh or MESHES["1pod"])


def test_batch_sharded_on_data():
    assert spec(("batch", "seq"), (256, 4096)) == ("data", None)


def test_batch_multi_pod():
    assert spec(("batch", "seq"), (256, 4096), MESHES["2pod"]) == (("pod", "data"), None)


def test_batch_one_replicated():
    assert spec(("batch", "seq"), (1, 524288), MESHES["2pod"]) == (None, None)


def test_heads_divisible():
    assert spec(("layers", "embed", "heads", "head_dim"),
                (36, 2048, 16, 128)) == (None, None, "model", None)


def test_heads_40_falls_back_to_head_dim():
    """qwen2.5-14b: 40 heads don't divide 16 -> shard head_dim instead."""
    assert spec(("layers", "embed", "heads", "head_dim"),
                (48, 5120, 40, 128)) == (None, None, None, "model")


def test_kv_heads_small_replicate():
    """kv=2 < 16 and q-heads divisible: kv weights replicate (GQA Megatron
    convention), no head_dim fallback."""
    assert spec(("layers", "embed", "kv_heads", "head_dim"),
                (36, 2048, 2, 128)) == (None, None, None, None)


def test_vocab_non_divisible_replicates():
    assert spec(("vocab", "embed"), (51865, 512)) == (None, None)
    assert spec(("vocab", "embed"), (151936, 2048)) == ("model", None)


def test_experts_sharded():
    assert spec(("layers", "experts", "embed", "mlp"),
                (48, 128, 2048, 768)) == (None, "model", None, None)


def test_decode_cache_rules():
    # decode rules shard cache_seq over whatever axes batch leaves free
    rules = default_rules({"cache_seq": ("pod", "data", "model")})
    m = MESHES["2pod"]
    # decode_32k: batch 128 takes pod+data, cache_seq gets model
    s = rules.spec_for(("layers", "batch", "cache_seq", "kv_heads",
                        "head_dim"), (48, 128, 32768, 8, 128), m)
    assert s == (None, ("pod", "data"), "model", None, None)
    # long_500k: batch 1 unshardable, cache_seq takes everything
    s = rules.spec_for(("layers", "batch", "cache_seq", "kv_heads",
                        "head_dim"), (48, 1, 524288, 8, 128), m)
    assert s == (None, None, ("pod", "data", "model"), None, None)


def test_fsdp_profile():
    rules = default_rules({"embed": ("data",)})
    s = rules.spec_for(("layers", "embed", "mlp"), (36, 2048, 11008), MESHES["1pod"])
    assert s == (None, "data", "model")
    # activations: batch wins the data axis, embed then replicates
    s = rules.spec_for(("batch", "seq", "embed"), (256, 4096, 2048), MESHES["1pod"])
    assert s == ("data", None, None)


AXES_POOL = ["batch", "seq", "embed", "heads", "kv_heads", "head_dim",
             "mlp", "vocab", "experts", "layers", "cache_seq", None]


def _flat_axes(s):
    out = []
    for part in s:
        if part is not None:
            out.extend(part if isinstance(part, tuple) else (part,))
    return out


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(AXES_POOL),
                          st.integers(1, 4096)), min_size=1, max_size=5))
def test_no_mesh_axis_used_twice(dims):
    """Spec invariant: a mesh axis may appear at most once, and every
    sharded dim divides evenly."""
    axes = tuple(a for a, _ in dims)
    shape = tuple(s for _, s in dims)
    m = MESHES["2pod"]
    s = RULES.spec_for(axes, shape, m)
    flat = _flat_axes(s)
    assert len(flat) == len(set(flat)), (axes, shape, s)
    for part, size in zip(s, shape):
        if part is not None:
            n = math.prod(m.shape[a] for a in (part if isinstance(part, tuple) else (part,)))
            assert size % n == 0, (axes, shape, s)


def test_tables_are_the_references():
    from repro.sharding.rules import DEFAULT_RULES as JAX_DEFAULT_RULES
    assert DEFAULT_RULES == JAX_DEFAULT_RULES
    assert dryrun.PROFILES == JAX_PROFILES
    for kind in ("train", "prefill", "decode"):
        assert dict(dryrun.rules_for(kind).table) == dict(
            jax_default_rules({"cache_seq": ("pod", "data", "model")}
                              if kind == "decode" else None).table)


def test_placements_order_major_to_minor():
    m = MESHES["2pod"]
    assert placements((("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert placements((None, None), m) == (Replicate(),) * 3
    assert local_shape((("pod", "data"), None, "model"), (64, 3, 32), m) == (2, 3, 2)


# ------------------------------------------- the property, both meshes ----
TABLES = {"default": None, "decode": {"cache_seq": ("pod", "data", "model")},
          "fsdp": JAX_PROFILES["fsdp"], "dponly": JAX_PROFILES["dponly"]}


def _jax_mesh(m: AbstractMesh):
    return JaxAbstractMesh(m.sizes, m.names, axis_types=(AxisType.Auto,) * len(m.sizes))


@pytest.fixture(scope="module", params=["1pod", "2pod"])
def fake_mesh(request):
    """A DeviceMesh of the production shape over a fake group of its size
    (one process; collectives move nothing), left after the module."""
    m = MESHES[request.param]
    join_fake_group(m.size)
    try:
        yield m, device_mesh(m, "cpu")
    finally:
        dist.destroy_process_group()


@settings(max_examples=60, deadline=None)
@given(dims=st.lists(st.tuples(st.sampled_from(AXES_POOL),
                               st.sampled_from([1, 2, 3, 8, 16, 40, 48, 128, 512,
                                                4096, 51865])),
                     min_size=1, max_size=5),
       table=st.sampled_from(sorted(TABLES)))
def test_spec_for_equals_the_references_and_dtensor_shards(fake_mesh, dims, table):
    m, dm = fake_mesh
    axes = tuple(a for a, _ in dims)
    shape = tuple(s for _, s in dims)
    ours = default_rules(TABLES[table]).spec_for(axes, shape, m)
    theirs = jax_default_rules(TABLES[table]).spec_for(axes, shape, _jax_mesh(m))
    assert ours == tuple(theirs) + (None,) * (len(shape) - len(theirs)), (axes, shape)
    want = tuple(size // math.prod(m.shape[a] for a in
                                   (() if p is None else p if isinstance(p, tuple) else (p,)))
                 for p, size in zip(ours, shape))
    got, _ = compute_local_shape_and_global_offset(shape, dm, placements(ours, m))
    assert tuple(got) == want == local_shape(ours, shape, m), (axes, shape, ours)


def test_tiny_meshes():
    assert tiny_mesh_shape().shape == {"data": 2, "model": 4}
    assert tiny_mesh_shape(multi_pod=True).shape == {"pod": 2, "data": 2, "model": 2}
    assert MESHES["2pod"].size == 512 and MESHES["1pod"].size == 256
