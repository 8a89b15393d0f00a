"""The port's gradient exchange against the JAX package, on the CPU.

* ``repro_torch.collectives.schedules`` is a copy of
  ``repro.collectives.schedules``: the same source, and the same outputs
  and ``CommStats`` for w 1-9 at several n.
* ``repro_torch.collectives.dist`` on gloo ranks at w in {2, 3, 4, 5, 8}
  (halving-doubling at the powers of two) and n in {1, 45, 1000, 65539}:
  every rank's ``ring_allreduce`` / ``halving_doubling_allreduce`` holds
  the bits that ``repro.collectives.xla`` computes under ``shard_map`` on
  the same f32 inputs (the JAX side runs in a subprocess with 8 host
  devices); they agree with the numpy schedules (f64) and with
  ``dist.all_reduce`` to 1e-5 of the largest element; ``exchange_tree``
  restores shapes and dtypes (a bf16 leaf included) as the reference's.

One spawn per world size runs all of its cases; each spawn and the JAX
subprocess have a time limit, so a deadlock fails instead of hanging.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro.collectives import schedules as jsched
from repro_torch.collectives import dist as tdist
from repro_torch.collectives import schedules as tsched
from repro_torch.launch.explicit_allreduce import spawn
from repro_torch.launch.mesh import init_data_group

WORLDS = (2, 3, 4, 5, 8)
SIZES = (1, 45, 1000, 65539)
RTOL = 1e-5  # max |got - want| / max |want|
TIMEOUT_S = 120
ROOT = Path(__file__).resolve().parents[1]


def pow2(w: int) -> bool:
    return w & (w - 1) == 0


def inputs(w: int, n: int) -> np.ndarray:
    """Rank r's vector is row r."""
    return np.random.default_rng([w, n]).standard_normal((w, n), dtype=np.float32)


def tree_inputs(w: int) -> dict:
    """Rank r's tree is index r of each leaf; ``b/c`` is bf16 in both
    packages (rounded from these f32 values)."""
    rng = np.random.default_rng([w, 7])
    return {"a": rng.standard_normal((w, 3, 5), dtype=np.float32),
            "b": {"c": rng.standard_normal((w, 7), dtype=np.float32)},
            "d": rng.standard_normal((w, 2, 2, 2), dtype=np.float32)}


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


# ------------------------------------------------- the numpy schedules ----
@pytest.mark.parametrize("name", ["CommStats", "_split_sizes", "ring_allreduce",
                                  "halving_doubling_allreduce",
                                  "binary_blocks_allreduce", "best_algorithm"])
def test_schedules_source_is_the_reference(name):
    assert inspect.getsource(getattr(tsched, name)) == inspect.getsource(
        getattr(jsched, name))
    assert sorted(tsched.ALGORITHMS) == sorted(jsched.ALGORITHMS)


@pytest.mark.parametrize("w", range(1, 10))
def test_schedules_copy_equals_original(w):
    for n in (1, 7, 45, 128, 1000):
        v = np.random.default_rng([w, n, 1]).normal(size=(w, n))
        for name in ("ring", "binary_blocks") + (("doubling_halving",) if pow2(w) else ()):
            mine, mstats = tsched.ALGORITHMS[name](v, itemsize=4)
            theirs, jstats = jsched.ALGORITHMS[name](v, itemsize=4)
            assert np.array_equal(mine, theirs), (name, n)
            assert vars(mstats) == vars(jstats), (name, n)
        for n_bytes in (1e3, 1e7, 1e8):
            assert tsched.best_algorithm(w, n_bytes) == jsched.best_algorithm(w, n_bytes)


# ------------------------------------------------------- gloo ranks ----
def _collectives_rank(rank, world, init_method, out_dir):
    torch.set_num_threads(1)
    init_data_group(rank, world, init_method, "gloo", "cpu", timeout_s=TIMEOUT_S / 2)
    try:
        out = {"transport": tdist.transport(None, torch.zeros(1))}
        for n in SIZES:
            x = torch.from_numpy(inputs(world, n)[rank])
            before = x.clone()
            out[f"ring/{n}"] = tdist.ring_allreduce(x)
            out[f"psum/{n}"] = tdist.psum(x)
            if pow2(world):
                out[f"doubling_halving/{n}"] = tdist.halving_doubling_allreduce(x)
            else:
                try:
                    tdist.halving_doubling_allreduce(x)
                except ValueError as e:
                    out["doubling_halving_error"] = str(e)
            out[f"input_kept/{n}"] = torch.equal(x, before)
        local = {"a": torch.from_numpy(tree_inputs(world)["a"][rank]),
                 "b": {"c": torch.from_numpy(tree_inputs(world)["b"]["c"][rank]
                                             ).to(torch.bfloat16)},
                 "d": torch.from_numpy(tree_inputs(world)["d"][rank])}
        for alg in ("ring", "doubling_halving") if pow2(world) else ("ring",):
            out[f"tree/{alg}"] = tdist.exchange_tree(local, None, alg)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


JAX_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.collectives.xla import (exchange_tree, halving_doubling_allreduce,
                                   ring_allreduce)
from test_torch_collectives import SIZES, WORLDS, inputs, pow2, tree_inputs

out, dtypes = {}, {}
for w in WORLDS:
    mesh = Mesh(np.array(jax.devices()[:w]), ("data",))
    xs = {str(n): jnp.asarray(inputs(w, n)) for n in SIZES}
    t = tree_inputs(w)
    tree = {"a": jnp.asarray(t["a"]), "b": {"c": jnp.asarray(t["b"]["c"], jnp.bfloat16)},
            "d": jnp.asarray(t["d"])}
    algs = {"ring": ring_allreduce}
    if pow2(w):
        algs["doubling_halving"] = halving_doubling_allreduce
    for name, fn in algs.items():
        def run(xs, tree, fn=fn, name=name):
            vecs = {n: fn(x[0], "data")[None] for n, x in xs.items()}
            local = jax.tree.map(lambda v: v[0], tree)
            ex = jax.tree.map(lambda v: v[None], exchange_tree(local, "data", name))
            return vecs, ex
        vecs, ex = jax.jit(jax.shard_map(run, mesh=mesh, in_specs=(P("data"), P("data")),
                                         out_specs=(P("data"), P("data")),
                                         check_vma=False))(xs, tree)
        for n, v in vecs.items():
            out[f"{name}/{w}/{n}"] = np.asarray(v)
        for path, v in (("a", ex["a"]), ("b/c", ex["b"]["c"]), ("d", ex["d"])):
            out[f"tree/{name}/{w}/{path}"] = np.asarray(v, np.float32)
            dtypes[f"tree/{name}/{w}/{path}"] = [str(v.dtype), list(v.shape)]
np.savez(sys.argv[1], **out)
print(json.dumps(dtypes))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"port": {w: [rank results]}, "jax": npz, "jax_dtypes": {...}}: the
    JAX subprocess runs while the gloo ranks do."""
    path = tmp_path_factory.mktemp("jax_allreduce") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(path)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        port = {w: spawn(_collectives_rank, w, (w,), TIMEOUT_S) for w in WORLDS}
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr
    with np.load(path) as z:
        jax_out = {k: z[k] for k in z.files}
    return {"port": port, "jax": jax_out,
            "jax_dtypes": json.loads(stdout.strip().splitlines()[-1])}


CASES = [(w, n, alg) for w in WORLDS for n in SIZES
         for alg in ("ring", "doubling_halving") if alg == "ring" or pow2(w)]


@pytest.mark.parametrize("w,n,alg", CASES)
def test_allreduce_bits_equal_reference_on_every_rank(runs, w, n, alg):
    want = runs["jax"][f"{alg}/{w}/{n}"]
    assert want.shape == (w, n)
    for r, res in enumerate(runs["port"][w]):
        got = res[f"{alg}/{n}"]
        assert got.dtype == torch.float32 and got.shape == (n,)
        assert np.array_equal(bits(got), bits(want[r])), f"rank {r}"
        assert np.array_equal(bits(got), bits(runs["port"][w][0][f"{alg}/{n}"]))
        assert res[f"input_kept/{n}"]


@pytest.mark.parametrize("w,n,alg", CASES)
def test_allreduce_matches_schedules_and_psum(runs, w, n, alg):
    v = inputs(w, n)
    exact, _ = tsched.ALGORITHMS[alg](v.astype(np.float64))
    for res in runs["port"][w]:
        got = res[f"{alg}/{n}"].double().numpy()
        scale = np.abs(exact[0]).max()
        assert np.abs(got - exact[0]).max() <= RTOL * scale
        assert np.abs(got - res[f"psum/{n}"].double().numpy()).max() <= RTOL * scale
    assert runs["port"][w][0]["transport"] == "gloo"


@pytest.mark.parametrize("w", [w for w in WORLDS if not pow2(w)])
def test_halving_doubling_refuses_other_world_sizes(runs, w):
    for res in runs["port"][w]:
        assert "power-of-two world size, got" in res["doubling_halving_error"]


@pytest.mark.parametrize("w", WORLDS)
def test_exchange_tree_restores_shapes_and_dtypes_as_reference(runs, w):
    t = tree_inputs(w)
    for alg in ("ring", "doubling_halving") if pow2(w) else ("ring",):
        for r, res in enumerate(runs["port"][w]):
            got = res[f"tree/{alg}"]
            assert set(got) == {"a", "b", "d"} and set(got["b"]) == {"c"}
            for path, leaf in (("a", got["a"]), ("b/c", got["b"]["c"]), ("d", got["d"])):
                key = f"tree/{alg}/{w}/{path}"
                dtype, shape = runs["jax_dtypes"][key]
                assert str(leaf.dtype).removeprefix("torch.") == dtype
                assert [w, *leaf.shape] == shape  # the reference's, stacked over ranks
                assert np.array_equal(bits(leaf.float()), bits(runs["jax"][key][r]))
            assert got["b"]["c"].dtype == torch.bfloat16
            np.testing.assert_allclose(got["a"].numpy(), t["a"].sum(0),
                                       rtol=0, atol=RTOL * np.abs(t["a"]).sum(0).max())


# ---------------------------------------------------------- refusals ----
def test_allreduce_refuses_unknown_algorithm_and_missing_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="unknown all-reduce algorithm 'tree'"):
        tdist.allreduce_(torch.zeros(4), None, "tree")
    for fn in (tdist.ring_allreduce, tdist.halving_doubling_allreduce, tdist.psum):
        with pytest.raises(RuntimeError, match="no torch.distributed process group"):
            fn(torch.zeros(4))
    with pytest.raises(ValueError, match="1-D contiguous"):
        tdist.allreduce_(torch.zeros(2, 2))


# --------------------------------------------- gloo-host on the card ----
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _staging_rank(rank, world, init_method, out_dir):
    init_data_group(rank, world, init_method, "gloo", "cuda", timeout_s=TIMEOUT_S / 2)
    try:
        out = {}
        for n in (45, 65539):
            x = torch.from_numpy(inputs(world, n)[rank])
            on_card = x.cuda()
            out[f"transport/{n}"] = tdist.transport(None, on_card)
            for alg in ("ring", "doubling_halving", "psum"):
                got = tdist.ALGORITHMS[alg](on_card)
                out[f"{alg}/{n}"] = (got.device.type, got.cpu(),
                                     tdist.ALGORITHMS[alg](x))
            out[f"input_kept/{n}"] = torch.equal(on_card.cpu(), x)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_gloo_host_staging_of_cuda_tensors(cuda):
    """A CUDA buffer on a gloo group is reduced through pinned host memory:
    the result is on the card and has the host run's bits."""
    for res in spawn(_staging_rank, 4, (4,), TIMEOUT_S):
        for n in (45, 65539):
            assert res[f"transport/{n}"] == "gloo-host" and res[f"input_kept/{n}"]
            for alg in ("ring", "doubling_halving", "psum"):
                where, got, on_host = res[f"{alg}/{n}"]
                assert where == "cuda"
                assert np.array_equal(bits(got), bits(on_host)), (alg, n)
