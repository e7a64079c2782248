"""The port's model-parallel (dp, tp) training against the JAX package's.

One spawn of four ``gloo`` processes on the CPU (a module-scoped fixture)
builds the meshes (4, 1), (2, 2) and (1, 4) from the same group and, on
each, trains the tiny DAC and Discriminator of
``tests/parallel/test_sharded_training.py`` from the JAX package's initial
parameters (through ``models.convert``): four reconstruction steps with a
checkpoint after the second, restored into fresh sharded models, and one
adversarial step. Rank 0 saves the results. Each case holds them to the JAX
test it mirrors, at that test's tolerance: the port's unsharded steps run
in this process, the JAX package's (2, 2) sharded step on the session's
virtual devices. The port-only checks of the design (identical data
replicas, the collectives at one rank, the selected weights, placement
rules, the data split, one checkpoint folder from four writers) come from
the same spawn.
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from audiotools_tpu.models import DAC as JDAC
from audiotools_tpu.models import Discriminator as JDisc
from audiotools_tpu.models.train import make_train_step as j_train_step
from audiotools_tpu.models.train import shard_params as j_shard_params
from audiotools_tpu.models.train import shard_params_rules as j_rules
from audiotools_tpu_torch.ml.checkpoint import Checkpointer
from audiotools_tpu_torch.models import DAC, Discriminator, convert
from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step
from audiotools_tpu_torch.models.train import make_train_step

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT = 240  # seconds: a hung rank fails the tests instead of the suite's clock
WORLD = 4
SHAPES = ((4, 1), (2, 2), (1, 4))
BATCH, T, SR = 8, 256, 16000
GEN = dict(encoder_dim=8, encoder_rates=(2, 2), latent_dim=16, decoder_dim=32, n_codebooks=2,
           codebook_size=32, codebook_dim=4, sample_rate=SR)
DISC = dict(periods=(2, 3), fft_sizes=(256, 128), mpd_channels=(4, 8), mrd_channels=4)
LR, ADV_LR = 1e-3, 1e-4


def _audio():
    return (np.random.RandomState(0).randn(BATCH, 1, T) * 0.1).astype(np.float32)


WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

rank, world, address, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
from audiotools_tpu_torch.data.datasets import ResumableDistributedSampler
from audiotools_tpu_torch.ml import Accelerator
from audiotools_tpu_torch.ml.checkpoint import Checkpointer
from audiotools_tpu_torch.models import DAC, Discriminator
from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step
from audiotools_tpu_torch.models.dac import Conv1d
from audiotools_tpu_torch.models.train import make_train_step, shard_params
from audiotools_tpu_torch.parallel import make_mesh
from audiotools_tpu_torch.parallel import tensor as tp_

dist.init_process_group("gloo", init_method=address, rank=rank, world_size=world)
cfg = json.load(open(f"{tmp}/config.json"))
gen_sd = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/gen.npz").items()}
disc_sd = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/disc.npz").items()}
audio = torch.from_numpy(np.load(f"{tmp}/audio.npy"))
res, meta = {}, {}


def adamw(params, lr):
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def placed(cls, kwargs, sd, mesh):
    model = cls(**kwargs)
    model.load_state_dict(sd)
    return shard_params(model, mesh)


def full(model):
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().clone()
            for k, v in model.state_dict().items()}


def sharded_dims(model):
    return {name: [p.dim for p in param.placements if p.is_shard()][0]
            for name, param in model.named_parameters()
            if any(p.is_shard() for p in param.placements)}


class Counts:
    # collectives launched, by wrapping torch.distributed's entry points
    def __init__(self):
        self.n = {"all_gather": 0, "all_reduce": 0}

    def __enter__(self):
        self.saved = {k: getattr(dist, k) for k in self.n}
        for k, fn in self.saved.items():
            def wrapped(*a, _k=k, _fn=fn, **kw):
                self.n[_k] += 1
                return _fn(*a, **kw)
            setattr(dist, k, wrapped)
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(dist, k, fn)


for dp, tp in cfg["shapes"]:
    key = f"{dp}x{tp}"
    mesh = make_mesh({"dp": dp, "tp": tp}, device="cpu")
    d_rank = mesh.get_local_rank("dp")
    mine = audio.chunk(dp)[d_rank]
    gen = placed(DAC, cfg["gen"], gen_sd, mesh)
    opt = adamw(gen.parameters(), cfg["lr"])
    step = make_train_step(gen, opt, cfg["sr"])
    with Counts() as counts:
        losses = [float(step(mine)["loss"])]
    meta[f"{key}/collectives"] = counts.n
    meta[f"{key}/hooks"] = len(tp_.placement(gen).handles)
    meta[f"{key}/n_params"] = sum(p.requires_grad for p in gen.parameters())
    # every data replica holds the same parameters after the update
    worst = 0.0
    group = mesh.get_group("dp")
    for p in gen.parameters():
        mine_p = p.to_local().detach().contiguous()
        parts = [torch.empty_like(mine_p) for _ in range(dp)]
        dist.all_gather(parts, mine_p, group=group)
        worst = max([worst] + [float((q - parts[0]).abs().max()) for q in parts])
    meta[f"{key}/replica_gap"] = worst
    losses.append(float(step(mine)["loss"]))
    after2 = full(gen)
    ck = Checkpointer(f"{tmp}/ck_{key}")
    ck.save(2, gen, opt)

    gen2 = placed(DAC, cfg["gen"], gen_sd, mesh)
    opt2 = adamw(gen2.parameters(), cfg["lr"])
    state, _ = ck.restore(template={"params": gen2, "opt_state": opt2})
    same, kept = True, True
    for (name, a), (_, b) in zip(gen.named_parameters(), gen2.named_parameters()):
        kept &= isinstance(b, DTensor) and b.placements == a.placements
        same &= torch.equal(a.full_tensor(), b.full_tensor())
    for s1, s2 in zip(opt.state.values(), opt2.state.values()):
        for k in ("exp_avg", "exp_avg_sq"):
            kept &= isinstance(s2[k], DTensor) and s2[k].placements == s1[k].placements
            same &= torch.equal(s1[k].full_tensor(), s2[k].full_tensor())
        same &= torch.equal(s1["step"], s2["step"])
    meta[f"{key}/restored_equal"], meta[f"{key}/restored_placements"] = bool(same), bool(kept)
    direct = float(step(mine)["loss"])
    step2 = make_train_step(gen2, opt2, cfg["sr"])
    losses.append(float(step2(mine)["loss"]))
    meta[f"{key}/direct_step3"] = direct
    losses.append(float(step2(mine)["loss"]))
    meta[f"{key}/losses"] = losses
    final = full(gen2)
    meta[f"{key}/gen_sharded"] = sharded_dims(gen)

    g = placed(DAC, cfg["gen"], gen_sd, mesh)
    d = placed(Discriminator, cfg["disc"], disc_sd, mesh)
    adv = make_adversarial_train_step(g, d, adamw(g.parameters(), cfg["adv_lr"]),
                                      adamw(d.parameters(), cfg["adv_lr"]), cfg["sr"])
    m = adv(mine)
    meta[f"{key}/adv"] = [float(m["loss"]), float(m["loss/discriminator"])]
    meta[f"{key}/disc_sharded"] = sharded_dims(d)
    if rank == 0:
        res.update({f"{key}/after2/{k}": v.numpy() for k, v in after2.items()})
        res.update({f"{key}/final/{k}": v.numpy() for k, v in final.items()})
    del gen, gen2, opt, opt2, g, d

# placement rules through the Accelerator, on (2, 2)
mesh = make_mesh({"dp": 2, "tp": 2}, device="cpu")


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv1d(4, 8, 3, padding=1)
        self.other = nn.Module()
        self.other.w = nn.Parameter(torch.ones(4, 4))


def placements(model):
    return {n: [f"Shard({p.dim})" if p.is_shard() else "Replicate" for p in q.placements]
            for n, q in model.named_parameters()}


def error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


accel = Accelerator(mesh=mesh)
toy = accel.prepare_model(Toy(), rules={"conv.weight": ("tp", None, None)})
meta["rules"] = placements(toy)
meta["rules_device"] = str(accel.device)
x = torch.randn(2, 4, 16, generator=torch.Generator().manual_seed(1))
whole = Toy()
whole.conv.load_state_dict({k: v.full_tensor() for k, v in toy.conv.state_dict().items()})
meta["rules_forward_gap"] = float((toy.conv(x) - whole.conv(x)).abs().max())
meta["no_rules"] = placements(Accelerator(mesh=mesh).prepare_model(Toy()))
meta["errors"] = {
    "data_axis": error(lambda: accel.prepare_model(Toy(), rules={"conv.weight": ("dp",)})),
    "bias": error(lambda: accel.prepare_model(Toy(), rules={"conv.bias": ("tp",)})),
    "other_layer": error(lambda: accel.prepare_model(Toy(), rules={"other.w": ("tp", None)})),
    "input_dim": error(lambda: accel.prepare_model(Toy(), rules={"conv.weight": (None, "tp")})),
    "no_tensor_axis": error(lambda: shard_params(Toy(), make_mesh({"dp": 4}, device="cpu"))),
    "no_data_axis": error(lambda: Accelerator(mesh=make_mesh({"x": 4}, device="cpu"))),
}

# the data split on (2, 2): one share per data rank
loader = accel.prepare_dataloader(list(range(16)), batch_size=4, num_workers=4)
share = {"indices": list(loader.sampler), "batch_size": loader.batch_size,
         "num_workers": loader.num_workers, "data_rank": mesh.get_local_rank("dp"),
         "tp_rank": mesh.get_local_rank("tp")}
shares = [None] * world
dist.all_gather_object(shares, share)
meta["shares"] = shares

# one step saved by four ranks, twice, over a stale temporary folder
gen = placed(DAC, cfg["gen"], gen_sd, mesh)
opt = adamw(gen.parameters(), cfg["lr"])
ck = Checkpointer(f"{tmp}/multi", max_to_keep=2)
paths = [str(ck.save(5, gen, opt, data_idx=5)), str(ck.save(5, gen, opt, data_idx=5))]
dist.barrier()
meta["multi_paths"] = paths
meta["multi_listing"] = sorted(p.name for p in ck.directory.iterdir())
meta["multi_files"] = sorted(p.name for p in (ck.directory / "5").iterdir())
if rank == 0:
    np.savez(f"{tmp}/out.npz", **res)
    with open(f"{tmp}/out.json", "w") as f:
        json.dump(meta, f)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _adamw(params, lr):
    # optax.adamw's defaults; torch's own default weight decay is 1e-2
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _jmesh(dp, tp):
    return Mesh(np.array(jax.devices()[: dp * tp]).reshape(dp, tp), ("dp", "tp"))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX models' initial parameters (the JAX test's keys and input)."""
    audio = jnp.asarray(_audio())
    gmodel, dmodel = JDAC(**GEN), JDisc(**DISC)
    gparams = jax.jit(gmodel.init)(jax.random.PRNGKey(0), audio)
    dparams = jax.jit(dmodel.init)(jax.random.PRNGKey(1), audio)
    return gmodel, gparams, dmodel, dparams


@pytest.fixture(scope="module")
def run(jax_side, tmp_path_factory):
    """The spawn: ``(results, meta, checkpoint root)``."""
    _, gparams, _, dparams = jax_side
    tmp = tmp_path_factory.mktemp("model_parallel")
    np.savez(tmp / "gen.npz", **{k: v.numpy() for k, v in
                                 convert.dac_state_dict(_np_tree(gparams)).items()})
    np.savez(tmp / "disc.npz", **{k: v.numpy() for k, v in
                                  convert.discriminator_state_dict(_np_tree(dparams)).items()})
    np.save(tmp / "audio.npy", _audio())
    (tmp / "config.json").write_text(json.dumps(
        {"shapes": SHAPES, "gen": GEN, "disc": DISC, "lr": LR, "adv_lr": ADV_LR, "sr": SR}))
    (tmp / "multi" / ".tmp-5-crashed").mkdir(parents=True)  # a save that crashed
    address = f"tcp://localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(WORLD), address,
                               str(tmp)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        outputs = [p.communicate(timeout=JOIN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outputs):
        assert p.returncode == 0, err[-3000:]
    meta = json.loads((tmp / "out.json").read_text())
    return dict(np.load(tmp / "out.npz")), meta, tmp


def _port(cls, kwargs, sd):
    model = cls(**kwargs)
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def unsharded(jax_side):
    """The port's unsharded run: four reconstruction steps (losses, final
    parameters) and one adversarial step, from the same weights and batch."""
    _, gparams, _, dparams = jax_side
    gen_sd = convert.dac_state_dict(_np_tree(gparams))
    disc_sd = convert.discriminator_state_dict(_np_tree(dparams))
    audio = torch.from_numpy(_audio())
    gen = _port(DAC, GEN, gen_sd)
    step = make_train_step(gen, _adamw(gen.parameters(), LR), SR)
    losses = [float(step(audio)["loss"]) for _ in range(4)]
    final = {k: v.detach().clone() for k, v in gen.state_dict().items()}
    g, d = _port(DAC, GEN, gen_sd), _port(Discriminator, DISC, disc_sd)
    m = make_adversarial_train_step(g, d, _adamw(g.parameters(), ADV_LR),
                                    _adamw(d.parameters(), ADV_LR), SR)(audio)
    return losses, final, (float(m["loss"]), float(m["loss/discriminator"]))


@pytest.fixture(scope="module")
def jax_sharded_loss(jax_side):
    """The JAX package's first (2, 2)-sharded step
    (``tests/parallel/test_sharded_training.py``'s step and optimizer)."""
    gmodel, gparams, _, _ = jax_side
    opt = optax.adamw(LR)
    step = jax.jit(j_train_step(gmodel, opt, SR))
    mesh = _jmesh(2, 2)
    ps = j_shard_params(gparams, mesh, "tp")
    a_sh = jax.device_put(jnp.asarray(_audio()), NamedSharding(mesh, P("dp", None, None)))
    with mesh:
        _, _, m = step(ps, opt.init(ps), a_sh)
    return float(m["loss"])


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


SHAPE_IDS = [_key(s) for s in SHAPES]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_first_step_loss_matches_the_unsharded_step(run, unsharded, shape):
    _, meta, _ = run
    got, want = meta[f"{_key(shape)}/losses"][0], unsharded[0][0]
    assert abs(got - want) / want < 1e-5


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_first_step_loss_matches_the_jax_sharded_step(run, jax_sharded_loss, shape):
    _, meta, _ = run
    got = meta[f"{_key(shape)}/losses"][0]
    assert abs(got - jax_sharded_loss) / jax_sharded_loss < 1e-5


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_losses_track_the_unsharded_trajectory(run, unsharded, shape):
    """As the JAX test pins it: step 2 within 1e-3, four steps within the
    chaos envelope of AdamW (5e-2), with a checkpoint after step 2."""
    _, meta, _ = run
    got, want = meta[f"{_key(shape)}/losses"], unsharded[0]
    assert abs(got[1] - want[1]) / want[1] < 1e-3
    np.testing.assert_allclose(got, want, rtol=5e-2)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_global_parameter_drift_after_four_steps(run, unsharded, shape):
    res, _, _ = run
    final = unsharded[1]
    num = sum(float(((torch.from_numpy(res[f"{_key(shape)}/final/{k}"]) - v) ** 2).sum())
              for k, v in final.items())
    den = sum(float((v ** 2).sum()) for v in final.values())
    assert (num / den) ** 0.5 < 0.1


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_restore_then_step_equals_the_uninterrupted_step(run, shape):
    _, meta, _ = run
    key = _key(shape)
    assert meta[f"{key}/losses"][2] == meta[f"{key}/direct_step3"]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_restored_state_is_bit_equal_and_keeps_its_placements(run, shape):
    _, meta, _ = run
    assert meta[f"{_key(shape)}/restored_equal"]
    assert meta[f"{_key(shape)}/restored_placements"]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_data_replicas_hold_identical_parameters(run, shape):
    """The data-axis average ran: every dp replica of each shard is equal
    after the update (each saw a different share of the batch)."""
    _, meta, _ = run
    assert meta[f"{_key(shape)}/replica_gap"] == 0.0


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_adversarial_step_agrees_across_mesh_shapes(run, unsharded, shape):
    _, meta, _ = run
    got = meta[f"{_key(shape)}/adv"]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, meta[f"{_key(SHAPES[0])}/adv"], rtol=2e-4)
    np.testing.assert_allclose(got, unsharded[2], rtol=2e-4)


def test_collectives_at_one_rank_launch_nothing(run):
    """(4, 1): no tensor-axis gather; one all-reduce a parameter (the data
    average) and one for the metrics. (1, 4): no data-axis hook."""
    _, meta, _ = run
    counts = meta["4x1/collectives"]
    assert counts["all_gather"] == 0
    assert counts["all_reduce"] == meta["4x1/n_params"] + 1
    assert meta["4x1/hooks"] == meta["4x1/n_params"]
    assert meta["1x4/hooks"] == 0
    assert meta["1x4/collectives"]["all_gather"] > 0


def _jax_selection(params, tp):
    """The weights the JAX rule shards at tensor size ``tp``, by port name,
    with the torch dim of their output channels: each JAX leaf is filled
    with its index times 4096 plus the index along its last (output) axis,
    converted, and read back."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    spec_for = j_rules(_jmesh(8 // tp, tp), "tp")
    marked, sharded = [], set()
    for i, (path, leaf) in enumerate(leaves):
        out = np.arange(leaf.shape[-1]) if leaf.ndim else 0
        marked.append(np.broadcast_to(i * 4096.0 + out, leaf.shape).astype(np.float32))
        if "tp" in str(spec_for(jax.tree_util.keystr(path), leaf)):
            sharded.add(i)
    tree = jax.tree_util.tree_unflatten(treedef, marked)
    return tree, sharded


@pytest.mark.parametrize("which", ["gen", "disc"])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_weights_are_the_jax_rules(run, jax_side, which, tp):
    """Through ``convert``'s name map: the port shards the weights the JAX
    rule shards (at the same tensor size, on (4, 2) and (2, 4) there), each
    on the torch dim of its output channels."""
    _, meta, _ = run
    gmodel, gparams, dmodel, dparams = jax_side
    params, to_sd = (gparams, convert.dac_state_dict) if which == "gen" else (
        dparams, convert.discriminator_state_dict)
    tree, sharded = _jax_selection(params, tp)
    want = {}
    for name, t in to_sd(_np_tree(tree)).items():
        if int(t.flatten()[0]) // 4096 in sharded:
            varying = [d for d in range(t.ndim) if t.shape[d] > 1 and bool(
                (t.remainder(4096).diff(dim=d) != 0).any())]
            want[name] = varying[0] if varying else None
    got = meta[f"{_key((4 // tp, tp))}/{which}_sharded"]
    assert want and got == want


def test_prepare_model_rules_shard_and_replicate(run):
    """``tests/ml/test_ml.py``'s pin in the torch layout: the named weight
    sharded on its output channels, its bias and every other parameter
    replicated; the sharded conv computes what the whole one does."""
    _, meta, _ = run
    assert meta["rules"] == {"conv.weight": ["Replicate", "Shard(0)"],
                             "conv.bias": ["Replicate", "Replicate"],
                             "other.w": ["Replicate", "Replicate"]}
    assert meta["rules_device"] == "cpu"
    assert meta["rules_forward_gap"] < 1e-6
    assert all(p == ["Replicate", "Replicate"] for p in meta["no_rules"].values())


@pytest.mark.parametrize("case,words", [
    ("data_axis", "data axis"), ("bias", "output dims"), ("other_layer", "output dims"),
    ("input_dim", "sharded on dim 1"), ("no_tensor_axis", "no dimension 'tp'"),
    ("no_data_axis", "no dimension 'dp'"),
])
def test_placements_the_layers_cannot_compute_raise(run, case, words):
    _, meta, _ = run
    said = meta["errors"][case]
    assert said is not None and said.startswith("ValueError") and words in said, said


def test_dataloader_gives_a_tensor_group_the_same_items(run):
    """On (2, 2) the two ranks of a tensor group take the same share of the
    indices and the two data ranks disjoint ones, covering the dataset; the
    batch is split over the data axis only."""
    _, meta, _ = run
    shares = meta["shares"]
    by_data = {}
    for s in shares:
        by_data.setdefault(s["data_rank"], []).append(s["indices"])
        assert s["batch_size"] == 2 and s["num_workers"] == 1
    assert sorted(by_data) == [0, 1]
    for group in by_data.values():
        assert len(group) == 2 and group[0] == group[1]
    a, b = by_data[0][0], by_data[1][0]
    assert not set(a) & set(b) and sorted(a + b) == list(range(16))


def test_four_ranks_saving_one_step_leave_one_whole_folder(run):
    """Rank 0 alone clears the stale temporary folder and writes; every
    rank returns the step's folder after the rename."""
    _, meta, tmp = run
    assert meta["multi_listing"] == ["5"]
    assert meta["multi_files"] == ["host_state.pkl", "state.pt"]
    assert meta["multi_paths"] == [str(tmp / "multi" / "5")] * 2


def test_sharded_checkpoint_restores_into_an_unsharded_model(run):
    """The (2, 2) step-2 checkpoint loads into plain modules and an
    optimizer, bit-equal to the sharded run's global parameters."""
    res, _, tmp = run
    gen = DAC(**GEN)
    opt = _adamw(gen.parameters(), LR)
    Checkpointer(tmp / "ck_2x2").restore(template={"params": gen, "opt_state": opt})
    for name, value in gen.state_dict().items():
        assert type(value) is torch.Tensor
        assert torch.equal(value, torch.from_numpy(res[f"2x2/after2/{name}"])), name
    assert all(type(s["exp_avg"]) is torch.Tensor for s in opt.state.values())
    assert len(opt.state) == len(list(gen.parameters()))


@pytest.mark.parametrize("T", [1, 5, 256])
def test_stft_of_a_clip_shorter_than_half_the_window_matches_jax(T):
    """The centre padding reflects again past the clip's ends, as
    ``jnp.pad`` does (the sharded tests' clips of 256 samples meet
    windows of 2048 in the losses)."""
    from audiotools_tpu.ops.fft import stft as jstft
    from audiotools_tpu_torch.ops.fft import stft as pstft

    x = np.random.RandomState(T).randn(2, T).astype(np.float32)
    want = np.asarray(jstft(jnp.asarray(x), 2048, 512))
    got = pstft(torch.from_numpy(x), 2048, 512).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
