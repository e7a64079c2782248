"""The port's ``Accelerator`` on the CPU: the amp helpers, both branches of
``prepare_dataloader`` against the JAX package's (the many-process branch by
faking the process count, as the JAX package's own test does), ``unwrap``,
and a two-process ``gloo`` run whose ``DistributedDataParallel`` gradient
equals the single-process full-batch gradient.

Tolerances: the DDP gradient within 1e-6 of the full-batch gradient (the
JAX package's pin for its sharded step against the unsharded one); the
loaders' indices equal.
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores
from torch import nn

from audiotools_tpu_torch import ml
from audiotools_tpu_torch.data.datasets import ResumableDistributedSampler, \
    ResumableSequentialSampler

ROOT = Path(__file__).resolve().parents[1]
DDP_TOL = 1e-6
JOIN_TIMEOUT = 180  # seconds: a hung worker fails the test instead of the suite's clock


@pytest.fixture(scope="module")
def speech_manifest(tmp_path_factory):
    from audiotools_tpu_torch.examples.train_dac import write_fixtures

    return write_fixtures(tmp_path_factory.mktemp("spk"))


def _datasets(manifest, n=8):
    from audiotools_tpu.data.datasets import AudioDataset as JDataset
    from audiotools_tpu.data.datasets import AudioLoader as JLoader
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader

    kw = dict(sample_rate=44100, n_examples=n, duration=0.25)
    return AudioDataset(AudioLoader(sources=[manifest]), **kw), \
        JDataset(JLoader(sources=[manifest]), **kw)


def test_defaults_without_a_process_group():
    accel = ml.Accelerator(device="cpu")
    assert (accel.world_size, accel.local_rank, accel.num_processes) == (1, 0, 1)
    assert accel.device == torch.device("cpu") and not accel.amp
    with accel as entered:
        assert entered is accel


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ml.Accelerator()


def test_amp_helpers():
    """``cast_for_compute`` casts floating tensors only, as the JAX package's
    does; ``autocast`` is bf16 autocast; the scaler passes through."""
    import jax.numpy as jnp

    from audiotools_tpu.ml import Accelerator as JAccelerator

    accel = ml.Accelerator(amp=True, device="cpu")
    tree = {"a": torch.ones(2, 2), "b": torch.ones(2, dtype=torch.int32),
            "c": [torch.zeros(3, dtype=torch.float64), "text"]}
    cast = accel.cast_for_compute(tree)
    want = JAccelerator(amp=True).cast_for_compute(
        {"a": jnp.ones((2, 2)), "b": jnp.ones((2,), jnp.int32), "c": [jnp.zeros(3)]})
    assert cast["a"].dtype == torch.bfloat16 and str(want["a"].dtype) == "bfloat16"
    assert cast["b"].dtype == torch.int32 and str(want["b"].dtype) == "int32"
    assert cast["c"][0].dtype == torch.bfloat16 and cast["c"][1] == "text"
    with accel.autocast():
        assert (torch.ones(2, 3) @ torch.ones(3, 2)).dtype == torch.bfloat16
    plain = ml.Accelerator(device="cpu")
    assert plain.cast_for_compute(tree) is tree
    with plain.autocast():
        assert (torch.ones(2, 3) @ torch.ones(3, 2)).dtype == torch.float32

    layer = nn.Linear(3, 1)
    opt = torch.optim.SGD(layer.parameters(), lr=0.5)
    before = layer.weight.detach().clone()
    accel.backward(layer(torch.ones(1, 3)).sum())
    assert torch.equal(layer.weight.grad, torch.ones(1, 3))
    accel.step(opt)
    accel.update()
    assert torch.equal(layer.weight.detach(), before - 0.5)
    assert accel.scaler.unscale_(opt) is opt and accel.scaler.scale(2.0) == 2.0


def test_placement_helpers():
    accel = ml.Accelerator(device="cpu")
    layer = nn.Linear(3, 2)
    assert accel.prepare_model(layer) is layer
    with pytest.raises(ValueError, match="partition rules need a mesh"):
        accel.prepare_model(layer, rules={"weight": None})
    step = lambda x: x + 1  # noqa: E731
    assert accel.jit_step(step, donate_argnums=(0,)) is step
    tree = {"x": torch.ones(2)}
    assert accel.shard(tree) is tree
    batch = accel.prepare_batch({"x": np.ones(3, np.float32), "name": "a"})
    assert isinstance(batch["x"], torch.Tensor) and batch["name"] == "a"


def test_unwrap():
    layer = nn.Linear(3, 2)
    assert ml.Accelerator.unwrap(layer) is layer
    assert ml.Accelerator.unwrap(nn.DataParallel(layer)) is layer
    assert ml.Accelerator.unwrap("model") == "model"


@pytest.mark.parametrize("start_idx", [None, 2])
def test_prepare_dataloader_one_process_matches_jax(speech_manifest, start_idx):
    from audiotools_tpu.ml import Accelerator as JAccelerator

    ds, jds = _datasets(speech_manifest)
    dl = ml.Accelerator(device="cpu").prepare_dataloader(ds, start_idx=start_idx, batch_size=2)
    jdl = JAccelerator().prepare_dataloader(jds, start_idx=start_idx, batch_size=2)
    assert isinstance(dl.sampler, ResumableSequentialSampler)
    assert dl.device == torch.device("cpu")
    got = [b["idx"].tolist() for b in dl]
    want = [np.asarray(b["idx"]).tolist() for b in jdl]
    assert got == want
    assert len(got) == (3 if start_idx == 2 else 4)


def test_prepare_dataloader_many_processes_matches_jax(speech_manifest):
    """The many-process branch: the interleaved resumable sampler and the
    batch size and workers divided by the process count (never below 1)."""
    from audiotools_tpu.ml import Accelerator as JAccelerator

    ds, jds = _datasets(speech_manifest)
    seen = {}
    for rank in (0, 1):
        accel, jaccel = ml.Accelerator(device="cpu"), JAccelerator()
        accel.num_processes = jaccel.num_processes = 2  # fake a 2-process world
        accel.local_rank = jaccel.local_rank = rank
        dl = accel.prepare_dataloader(ds, batch_size=4, num_workers=4)
        jdl = jaccel.prepare_dataloader(jds, batch_size=4, num_workers=4)
        assert isinstance(dl.sampler, ResumableDistributedSampler)
        assert (dl.batch_size, dl.num_workers) == (jdl.batch_size, jdl.num_workers) == (2, 2)
        seen[rank] = list(dl.sampler)
        assert seen[rank] == list(jdl.sampler)
    assert set(seen[0]).isdisjoint(seen[1]) and len(seen[0]) + len(seen[1]) == 8

    accel, jaccel = ml.Accelerator(device="cpu"), JAccelerator()
    accel.num_processes = jaccel.num_processes = 2
    dl = accel.prepare_dataloader(ds, start_idx=4, batch_size=4)
    jdl = jaccel.prepare_dataloader(jds, start_idx=4, batch_size=4)
    first_epoch = list(dl.sampler)  # the resume point holds for the first epoch only
    assert first_epoch == list(jdl.sampler) and len(first_epoch) == 2

    accel.num_processes = 16
    dl = accel.prepare_dataloader(ds, batch_size=4, num_workers=4)
    assert dl.batch_size == 1 and dl.num_workers == 1


WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch import nn

rank, world, address, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=address, rank=rank, world_size=world)
from audiotools_tpu_torch import ml
from audiotools_tpu_torch.ml.decorators import Tracker

torch.manual_seed(0)
model = nn.Sequential(nn.Conv1d(1, 4, 5), nn.Tanh(), nn.Conv1d(4, 2, 3))
accel = ml.Accelerator(device="cpu")
assert (accel.world_size, accel.local_rank, accel.num_processes) == (world, rank, world)
net = accel.prepare_model(model)
assert isinstance(net, nn.parallel.DistributedDataParallel)
assert accel.unwrap(net) is model
x = torch.from_numpy(np.random.RandomState(1).randn(8, 1, 40).astype(np.float32))
share = x[rank::world]
accel.backward(net(share).pow(2).mean())
grads = {k: p.grad.tolist() for k, p in model.named_parameters()}

tracker = Tracker(rank=rank)
step = tracker.track("train", 1)(lambda: {"loss": float(rank + 1)})
mean = step()["loss"]
json.dump({"grads": grads, "tracker_mean": mean}, open(out, "w"))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_ddp_gradient_of_two_gloo_processes_equals_the_full_batch_gradient(tmp_path):
    """Two processes on the CPU (``gloo``), each with half of a batch of 8:
    DDP's averaged gradient against the gradient of the whole batch in one
    process; the Tracker averages a scalar over the two processes."""
    world = 2
    address = f"tcp://localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), address,
                               str(tmp_path / f"rank{r}.json")], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outputs = [p.communicate(timeout=JOIN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outputs):
        assert p.returncode == 0, err[-3000:]

    torch.manual_seed(0)
    model = nn.Sequential(nn.Conv1d(1, 4, 5), nn.Tanh(), nn.Conv1d(4, 2, 3))
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 1, 40).astype(np.float32))
    model(x).pow(2).mean().backward()
    want = {k: p.grad.numpy() for k, p in model.named_parameters()}
    for r in range(world):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["tracker_mean"] == 1.5
        for k, w in want.items():
            g = np.asarray(got["grads"][k], np.float32)
            assert np.abs(g - w).max() <= DDP_TOL, (r, k, np.abs(g - w).max())
