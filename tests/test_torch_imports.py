"""The port stands alone: importing every repro_torch module loads neither
jax nor any module of the JAX package ``repro``; its entry points refuse to
run without a GPU unless asked for the CPU; and on the CPU no kernel is
launched."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
ROOT = SRC.parent


def _port_modules() -> list[str]:
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def _loaded_after(code: str) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\n"
         "print(json.dumps(sorted(sys.modules)))"],
        env=env, cwd=ROOT, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _foreign(modules: list[str]) -> list[str]:
    return [m for m in modules
            if m == "jax" or m.startswith("jax.") or m == "jaxlib"
            or m.startswith("jaxlib.") or m == "repro" or m.startswith("repro.")]


def test_every_module_imports_without_jax_or_repro():
    names = _port_modules()
    assert {"repro_torch.launch.serve", "repro_torch.kernels.swa_attention",
            "repro_torch.kernels.rmsnorm", "repro_torch.bridge",
            "repro_torch.configs.resnet110", "repro_torch.data.synthetic",
            "repro_torch.kernels.fused_update", "repro_torch.optim.schedule",
            "repro_torch.optim.optimizers", "repro_torch.models.resnet",
            "repro_torch.checkpoint.store", "repro_torch.engine.steps",
            "repro_torch.core.elastic", "repro_torch.collectives",
            "repro_torch.collectives.schedules", "repro_torch.collectives.dist",
            "repro_torch.launch.mesh", "repro_torch.launch.explicit_allreduce",
            "repro_torch.launch.train", "repro_torch.models.moe",
            "repro_torch.configs.qwen2_vl_2b", "repro_torch.configs.qwen3_moe_30b_a3b",
            "repro_torch.configs.dbrx_132b", "repro_torch.configs.qwen25_14b",
            "repro_torch.models.whisper", "repro_torch.configs.whisper_base",
            "repro_torch.collectives.cost", "repro_torch.core.convergence",
            "repro_torch.core.resource_model", "repro_torch.core.jobs",
            "repro_torch.core.telemetry", "repro_torch.core.scheduler",
            "repro_torch.core.faults", "repro_torch.core.placement",
            "repro_torch.core._reference", "repro_torch.core.simulator",
            "repro_torch.sharding", "repro_torch.sharding.rules",
            "repro_torch.launch.analysis", "repro_torch.launch.dryrun"} <= set(names)
    loaded = _loaded_after("\n".join(f"import {n}" for n in names))
    assert "repro_torch" in loaded and "torch" in loaded
    assert _foreign(loaded) == []


def test_chip_smoke_imports_without_jax_or_repro():
    loaded = _loaded_after(
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))")
    assert {"repro_torch.launch.serve", "repro_torch.core.elastic",
            "repro_torch.launch.explicit_allreduce",
            "repro_torch.models.whisper", "repro_torch.core.simulator"} <= set(loaded)
    assert _foreign(loaded) == []


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.launch.explicit_allreduce",
                                    "repro_torch.models.whisper"])
def test_changed_launchers_and_whisper_import_alone_without_jax_or_repro(module):
    """Each on its own (the data-parallel launchers and the audio model),
    in a fresh interpreter."""
    loaded = _loaded_after(f"import {module}")
    assert module in loaded and _foreign(loaded) == []


@pytest.mark.parametrize("module", ["repro_torch.sharding.rules",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.analysis",
                                    "repro_torch.launch.dryrun"])
def test_sharding_and_dryrun_modules_import_alone_without_jax_or_repro(module):
    """The sharding rules, the meshes, the roofline and the dry-run, each
    on its own in a fresh interpreter; the dry-run's CLI help runs too."""
    loaded = _loaded_after(f"import {module}")
    assert module in loaded and _foreign(loaded) == []
    if module.endswith("dryrun"):
        env = dict(os.environ, PYTHONPATH=str(SRC))
        out = subprocess.run([sys.executable, "-m", module, "--help"], env=env,
                             cwd=ROOT, capture_output=True, text=True, check=True)
        assert "--skip-costs" in out.stdout and "--save-hlo" not in out.stdout


def test_chip_smoke_fails_without_a_gpu():
    """No CUDA device: exit non-zero and print no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                         cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_train_lr_imports_without_jax_or_repro():
    loaded = _loaded_after(
        "import sys, importlib.util\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"spec = importlib.util.spec_from_file_location('chip_train_lr', {str(ROOT / 'chip_train_lr.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))")
    assert {"chip_smoke", "repro_torch.core.elastic"} <= set(loaded)
    assert _foreign(loaded) == []


def test_chip_nccl_imports_without_jax_or_repro():
    loaded = _loaded_after(
        "import sys, importlib.util\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"spec = importlib.util.spec_from_file_location('chip_nccl', {str(ROOT / 'chip_nccl.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))")
    assert {"chip_smoke", "repro_torch.launch.explicit_allreduce",
            "repro_torch.collectives.dist"} <= set(loaded)
    assert _foreign(loaded) == []


def test_chip_nccl_fails_without_four_gpus():
    """Fewer than four cards (here none): exit non-zero, print nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_nccl.py")], env=env,
                         cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "needs 4 CUDA devices" in out.stderr


def test_chip_train_lr_fails_without_a_gpu():
    """No CUDA device: the LR sweep exits non-zero and prints nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_train_lr.py"),
                          "--lrs", "3e-4"], env=env, cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_fails_alone(tmp_path):
    """Copied without the rest of the repo, chip_smoke.py cannot run."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout == ""


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine.steps import make_decode_step, make_prefill
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen2.5-3b")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(cfg, batch=1, prompt_len=2, new_tokens=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_prefill(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_decode_step(model)
    make_prefill(model, device="cpu")
    make_decode_step(model, device="cpu")


def test_trainer_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs.resnet110 import smoke_config
    from repro_torch.core.elastic import ElasticTrainer
    from repro_torch.data.synthetic import CifarLike
    from repro_torch.engine.steps import init_train_state, make_train_step
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.optim import sgd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, opt = ResNetModel(smoke_config()), sgd()
    args = (model, opt, CifarLike(size=16), CheckpointStore(str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ElasticTrainer(*args, base_lr_1w=0.1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(model, opt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(model, opt)
    ElasticTrainer(*args, base_lr_1w=0.1, device="cpu")
    make_train_step(model, opt, device="cpu")
    init_train_state(model, opt, device="cpu")


def _resnet_step(**kwargs):
    from repro_torch.configs.resnet110 import smoke_config
    from repro_torch.engine.steps import make_train_step
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.optim import sgd

    return make_train_step(ResNetModel(smoke_config()), sgd(), device="cpu", **kwargs)


@pytest.mark.parametrize("name", ["tree", "binary_blocks", "RING"])
def test_train_step_refuses_an_unknown_exchange(name):
    with pytest.raises(ValueError, match=f"unknown grad_exchange '{name}'"):
        _resnet_step(grad_exchange=name)


@pytest.mark.parametrize("name", ["ring", "doubling_halving", "psum"])
def test_train_step_exchange_needs_a_process_group(name):
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=f"grad_exchange='{name}' needs an "
                       "initialised torch.distributed process group"):
        _resnet_step(grad_exchange=name)


def test_train_step_refuses_a_batch_that_microbatches_do_not_split():
    from repro_torch.configs.resnet110 import smoke_config
    from repro_torch.data.synthetic import CifarLike
    from repro_torch.engine.steps import init_train_state
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.optim import sgd

    state = init_train_state(ResNetModel(smoke_config()), sgd(), device="cpu")
    with pytest.raises(ValueError, match="a batch of 6 rows does not split into 4"):
        _resnet_step(microbatches=4)(state, CifarLike(size=16).batch(0, 6), 0.1)
    with pytest.raises(ValueError, match="microbatches must be at least 1"):
        _resnet_step(microbatches=0)


def test_lm_trainer_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "1", "--seq", "8",
            "--m-per-worker", "1", "--log-every", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(args)
    first, last = train.main(args + ["--device", "cpu"])
    assert np.isfinite(first) and first == last
    assert "step     0 loss" in capsys.readouterr().out


@pytest.mark.parametrize("call", ["rmsnorm", "swa_attention"])
def test_kernel_wrappers_still_refuse_grad_outside_the_functions(call):
    """Called directly, a kernel wrapper refuses an input that requires
    grad; through kernels.ops the same input goes to the autograd
    Function, whose forward runs with grad off."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms_kernel
    from repro_torch.kernels import swa_attention as swa_kernel

    x = torch.ones(2, 8, 32, requires_grad=True)
    w = torch.zeros(32)
    with pytest.raises(RuntimeError, match="no backward"):
        if call == "rmsnorm":
            rms_kernel.rmsnorm(x, w)
        else:
            swa_kernel.swa_attention(x, x, x)
    out = ops.rmsnorm(x, w) if call == "rmsnorm" else ops.swa_attention(x, x, x)
    assert out.grad_fn is not None and "Backward" in type(out.grad_fn).__name__
    out.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_dp_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from repro_torch.launch import explicit_allreduce as ea
    from repro_torch.launch.mesh import init_data_group, local_rows

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rdzv = f"file://{tmp_path}/rdzv"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_data_group(0, 1, rdzv, "gloo")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ea.run(ea.DPRun())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ea.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ea.main(["--arch", "resnet-110"])
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        init_data_group(0, 1, rdzv, "nccl", device="cpu")
    with pytest.raises(ValueError, match="12 rows does not split over 5 ranks"):
        local_rows({"x": np.zeros(12)}, 0, 5)
    assert local_rows({"x": np.arange(12)}, 2, 4)["x"].tolist() == [6, 7, 8]


def test_steps_refuse_params_on_another_device():
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine.steps import make_prefill
    from repro_torch.models.registry import build_model

    model = build_model(get_smoke_config("qwen2.5-3b"))
    params = model.init(torch.Generator().manual_seed(0), "meta")
    with pytest.raises(ValueError, match="params are on meta"):
        make_prefill(model, device="cpu")(params, {"tokens": np.zeros((1, 2), np.int32)})


def test_no_kernel_launches_on_the_cpu():
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine.steps import make_prefill
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model

    ops.reset_launch_counts()
    cfg = get_smoke_config("h2o-danube-1.8b")
    serve(cfg, batch=2, prompt_len=4, new_tokens=2, device="cpu",
          generator=torch.Generator().manual_seed(0))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    logits = make_prefill(model, device="cpu")(
        params, {"tokens": np.zeros((2, 40), np.int32)})
    assert logits.shape == (2, 40, cfg.vocab_size)
    assert ops.launch_counts() == {"rmsnorm": 0, "swa_attention": 0,
                                   "fused_sgd_update": 0, "ssd": 0, "ssd_backward": 0}


def test_no_kernel_launches_in_a_cpu_training_segment(tmp_path):
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs.resnet110 import smoke_config
    from repro_torch.core.elastic import ElasticTrainer
    from repro_torch.data.synthetic import CifarLike
    from repro_torch.kernels import ops
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.optim import sgd

    ops.reset_launch_counts()
    tr = ElasticTrainer(ResNetModel(smoke_config()), sgd(), CifarLike(size=64),
                        CheckpointStore(str(tmp_path)), base_lr_1w=0.05,
                        m_per_worker=4, device="cpu")
    r = tr.train_segment(w=2, n_steps=3, resume=False, log_every=1)
    assert len(r.losses) == 3 and all(np.isfinite(l) for _, _, l in r.losses)
    assert ops.launch_counts() == {"rmsnorm": 0, "swa_attention": 0,
                                   "fused_sgd_update": 0, "ssd": 0, "ssd_backward": 0}
