"""The port's NCCL route on the CPU, where no card is: which card each rank
takes, the refusals that fire before any rank starts (too few cards, or
the CPU), ``chip_nccl.py``'s fit of alpha, beta and gamma, the H100
coefficient set beside the paper's InfiniBand (which stays the default),
and the launcher's depth cut and parameter checksum."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import inspect
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.collectives import cost, schedules
from repro_torch.launch import explicit_allreduce as ea
from repro_torch.launch import mesh, train

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cards(monkeypatch):
    """Pretend to see ``n`` cards (``cards(n)``); any spawn, build or
    process group started afterwards fails the test."""
    def see(n: int):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

    def started(*a, **k):
        raise AssertionError("started before the refusal")

    monkeypatch.setattr(ea, "spawn", started)
    monkeypatch.setattr(ea.build, "build_all", started)
    monkeypatch.setattr(dist, "init_process_group", started)
    return see


@pytest.mark.parametrize("rank", range(4))
def test_dprun_nccl_puts_rank_r_on_card_r(rank):
    assert ea.rank_device(ea.DPRun(backend="nccl"), rank) == torch.device("cuda", rank)
    # gloo ranks share the run's device
    assert ea.rank_device(ea.DPRun(), rank) == torch.device("cuda")
    assert ea.rank_device(ea.DPRun(device="cpu"), rank) == torch.device("cpu")


def test_dprun_nccl_with_too_few_cards_raises_before_any_spawn(cards):
    cards(2)
    with pytest.raises(ValueError, match="4 ranks need 4 cards, 2 visible"):
        ea.run(ea.DPRun(backend="nccl", world=4))
    with pytest.raises(ValueError, match="3 ranks need 3 cards, 2 visible"):
        ea.run(ea.DPRun(backend="nccl", world=3))


def test_dprun_nccl_on_the_cpu_raises_before_any_spawn(cards):
    cards(4)
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        ea.run(ea.DPRun(backend="nccl", device="cpu"))


def test_gloo_ranks_may_share_a_card():
    mesh.check_cards("gloo", 4, "cpu")  # no card needed, none checked


def test_train_nccl_on_the_cpu_raises():
    with pytest.raises(ValueError, match="--backend nccl needs the card"):
        train.main(["--arch", "qwen2.5-3b", "--smoke", "--backend", "nccl",
                    "--device", "cpu"])


@pytest.mark.parametrize("local_world,refused", [(None, True), ("2", False)])
def test_train_nccl_counts_the_ranks_on_this_host(cards, monkeypatch, local_world, refused):
    """Under torchrun, 4 nccl ranks and 2 visible cards raise before the
    group starts; 2 of the 4 on this host (two hosts) do not."""
    cards(2)
    for k, v in {"WORLD_SIZE": "4", "RANK": "1", "LOCAL_RANK": "1"}.items():
        monkeypatch.setenv(k, v)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    joined = []
    monkeypatch.setattr(train, "init_data_group",
                        lambda rank, world, init, backend, dev: joined.append(
                            (rank, world, backend, dev)) or dev)
    if refused:
        with pytest.raises(ValueError, match="4 ranks need 4 cards, 2 visible"):
            train._join("cuda", "nccl")
        assert joined == []
    else:
        dev, own = train._join("cuda", "nccl")
        assert own and joined == [(1, 4, "nccl", torch.device("cuda", 1))]


def test_calibration_fit_recovers_alpha_beta_gamma():
    """Times synthesised through the schedules' counters: a ring-neighbour
    round sends s bytes in one message, the add reduces s bytes."""
    sys.path.insert(0, str(ROOT))
    import chip_nccl

    alpha, beta, gamma = 2.7e-5, 1 / 183e9, 1 / 951e9
    rounds = {s: schedules.CommStats(steps=1, bytes_sent=s).time(alpha, beta, gamma)
              for s in chip_nccl.ROUND_BYTES}
    adds = {s: schedules.CommStats(bytes_reduced=s).time(alpha, beta, gamma)
            for s in chip_nccl.ROUND_BYTES}
    fit = chip_nccl.fit_coefficients(rounds, adds)
    for k, want in (("alpha", alpha), ("beta", beta), ("gamma", gamma)):
        assert abs(fit[k] - want) <= 1e-6 * want, (k, fit[k], want)
    assert abs(fit["add_intercept"]) <= 1e-6 * adds[chip_nccl.ROUND_BYTES[0]]
    # the prediction is the ring's counters at the fitted values
    hw = cost.HardwareCoefficients(alpha=fit["alpha"], beta=fit["beta"],
                                   gamma=fit["gamma"], name="fit")
    w, n_bytes = 4, 4 << 20
    _, st = schedules.ring_allreduce(np.zeros((w, w)), itemsize=n_bytes // w)
    got = chip_nccl.predict(hw, w, n_bytes, "ring")
    assert got["counters"] == pytest.approx(st.time(alpha, beta, gamma), rel=1e-6)
    assert got["eq"] == pytest.approx(cost.t_ring(0, 0.0, 0.0, w, n_bytes, hw), rel=1e-12)


def test_h100_nvlink_coefficients_beside_the_default():
    hw = cost.H100_NVLINK
    assert hw.name == "h100_nvlink"
    assert all(np.isfinite(v) and v > 0 for v in (hw.alpha, hw.beta, hw.gamma))
    # a faster fabric than the paper's InfiniBand, per byte
    assert hw.beta < cost.INFINIBAND_100G.beta
    for fn in ("t_ring", "t_dh", "t_bb", "step_time", "step_time_table",
               "simulated_step_time"):
        assert inspect.signature(getattr(cost, fn)).parameters["hw"].default is \
            cost.INFINIBAND_100G, fn
    assert cost.ClusterModel().hw is cost.INFINIBAND_100G
    assert cost.ClusterModel(hw=hw).hw is hw


def test_train_cuts_depth_with_layers(capsys):
    first, last = train.main(["--arch", "qwen2.5-3b", "--smoke", "--layers", "1",
                              "--steps", "2", "--m-per-worker", "1", "--seq", "8",
                              "--device", "cpu"])
    assert np.isfinite(first) and np.isfinite(last)


def test_checksum_sees_every_word_and_its_place():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    c = train.checksum(x)
    assert c == train.checksum(x.clone()) and len(c) == 32
    flipped = x.clone()
    flipped.view(torch.int32)[999] ^= 1
    swapped = x.clone()
    swapped[[3, 7]] = x[[7, 3]]
    assert len({c, train.checksum(flipped), train.checksum(swapped)}) == 3


def test_chip_smoke_table3_under_the_h100_coefficients():
    """chip_smoke's sched phase runs Table 3 with the jobs' and the
    cluster's coefficients set to the H100s' (the default stays the
    paper's InfiniBand): every job completes and the two engines agree
    bit for bit under both."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert inspect.signature(chip_smoke.card_table3).parameters["hw"].default is \
        cost.INFINIBAND_100G
    t_fwd, t_back = 0.25e-3, 0.5e-3  # a card's profile, seconds an image
    runs = {hw.name: chip_smoke.card_table3(t_fwd, t_back, 10.0, hw)
            for hw in (cost.INFINIBAND_100G, cost.H100_NVLINK)}
    for name, t in runs.items():
        assert t["hw"] == name
        assert all(all(row.values()) for row in t["completed"].values()), name
        assert t["engines_bit_identical_none_precompute"], name
