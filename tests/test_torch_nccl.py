"""The exchange over NCCL on two cards, one a rank (``cuda``-marked: it
skips without two GPUs): ring and halving-doubling all-reduce of seeded
inputs bit for bit equal to the same schedules over gloo on the host, in
the same two processes, and ``dist.all_reduce`` within 1e-5 of the
largest element. ``chip_nccl.py`` runs the same check at w = 2, 3, 4 on
four cards.

  python3 -m pytest -q -m cuda tests/test_torch_nccl.py
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.collectives import dist as tdist
from repro_torch.launch.explicit_allreduce import spawn
from repro_torch.launch.mesh import init_data_group

WORLD = 2
SIZES = (1, 45, 1000, 65539, 1_727_962)
TIMEOUT_S = 240


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA GPUs, one a rank")


def _nccl_rank(rank, world, init_method, out_dir):
    dev = init_data_group(rank, world, init_method, "nccl", torch.device("cuda", rank),
                          TIMEOUT_S / 2)
    try:
        host = dist.new_group(backend="gloo")
        out = {"card": dev.index}
        for n in SIZES:
            x = torch.from_numpy(np.random.default_rng([7, world, n, rank])
                                 .standard_normal(n).astype(np.float32))
            on_card = x.to(dev)
            out[f"transport/{n}"] = tdist.transport(None, on_card)
            for alg in ("ring", "doubling_halving", "psum"):
                out[f"{alg}/{n}"] = (tdist.ALGORITHMS[alg](on_card).cpu(),
                                     tdist.ALGORITHMS[alg](x, host))
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_exchange_matches_gloo_bits_on_two_cards(two_cards):
    ranks = spawn(_nccl_rank, WORLD, (WORLD,), TIMEOUT_S)
    assert [r["card"] for r in ranks] == list(range(WORLD))
    for r in ranks:
        for n in SIZES:
            assert r[f"transport/{n}"] == "nccl"
            for alg in ("ring", "doubling_halving"):
                got, want = r[f"{alg}/{n}"]
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (alg, n)
            got, want = r[f"psum/{n}"]
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
