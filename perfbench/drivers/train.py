"""Driver of DAC's adversarial training step:
``models.adversarial.make_adversarial_train_step(DAC, Discriminator, AdamW,
AdamW)`` on batches of seeded clips, as ``chip_smoke.py`` phase 8 runs it.

Set-up builds the models without initializing them (on the ``meta``
device), places them on the card and loads weights made there from the
seed (``reference.dac.make_weights``, which the reference remakes), builds
the optimizers and the step, and stages a pool of batches of distinct
seeded clips. It then drives the step through its first ``checked_steps``
steps on the pool's first batches, through the window's own call: these
are the steps the reference follows, and the warm-up. The window is a
closed loop of steps over the pool, at most ``in_flight`` dispatched ahead.

``check`` compares each checked step's generator and discriminator loss,
the first step's gradient of every leaf (read from AdamW's first moment,
``m = (1 - beta1) g``) and every leaf's change over the checked steps
with the plain reference (``reference/adversarial.py``), run from the same
weights and batches in full fp32.
"""
import time
from collections import deque

import numpy as np
import torch

from perfbench.harness import device as dev
from perfbench.reference import adversarial as ref
from perfbench.reference import dac as ref_dac
from perfbench.reference.chain import rounding
from perfbench.traffic import clips as traffic
from perfbench.work import dac as work


def make_batches(config, mix, seed):
    """``pool`` batches of ``batch`` clips of ``samples`` samples, every clip
    its own seeded signal, cycling through the mix's kinds."""
    n = mix["pool"] * config["batch_size"]
    seeds = traffic.sub_seeds(seed, n, salt=11)
    kinds = mix["kinds"]
    seconds = config["samples"] / config["sample_rate"] + 0.01
    clips = np.stack([traffic.GENERATORS[kinds[i % len(kinds)]](s, seconds, config["sample_rate"])
                      [: config["samples"]] for i, s in enumerate(seeds)])
    audio = torch.from_numpy(clips).to(dev.device())[:, None, :]
    return list(audio.split(config["batch_size"]))


def weights(config, seed, device):
    gen = ref_dac.make_weights(ref_dac.param_specs(**config["widths"]), seed, device)
    disc = ref_dac.make_weights(ref.disc_specs(**config["discriminator"]), seed + 1, device)
    return gen, disc


def load_weights(module, w):
    """Copy the weights ``w`` (by parameter name) into ``module``."""
    params = dict(module.named_parameters())
    if set(params) != set(w):
        raise RuntimeError(f"weights do not match the model: {sorted(set(params) ^ set(w))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(w[name])


def build(config, seed, device):
    from audiotools_tpu_torch.models import DAC, Discriminator
    from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step

    with torch.device("meta"):
        gen = DAC(**config["widths"], sample_rate=config["sample_rate"])
        disc = Discriminator(**config["discriminator"])
    gen, disc = gen.to_empty(device=device), disc.to_empty(device=device)
    g_w, d_w = weights(config, seed, device)
    load_weights(gen, g_w)
    load_weights(disc, d_w)
    del g_w, d_w
    opt = config["optimizer"]

    def adamw(module):
        return torch.optim.AdamW(module.parameters(), lr=opt["lr"], betas=tuple(opt["betas"]),
                                 eps=opt["eps"], weight_decay=opt["weight_decay"])

    g_opt, d_opt = adamw(gen), adamw(disc)
    step = make_adversarial_train_step(gen, disc, g_opt, d_opt, config["sample_rate"])
    return gen, disc, g_opt, d_opt, step


def _leaf_norms(named):
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in named}


def setup(config, mix, seed, spans):
    device = dev.device()
    seed = int(seed)
    # the configuration's precision: fp32 products, TF32 on or off
    torch.backends.cudnn.allow_tf32 = config["allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = config["allow_tf32"]
    gen, disc, g_opt, d_opt, step = build(config, seed, device)
    pool = make_batches(config, mix, seed)
    beta1 = config["optimizer"]["betas"][0]
    checked = []
    for i in range(mix["checked_steps"]):
        metrics = step(pool[i])
        checked.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            grads = {}
            for prefix, module, opt in (("gen", gen, g_opt), ("disc", disc, d_opt)):
                # a leaf the optimizer never stepped has no moment: a zero gradient
                grads.update(_leaf_norms(
                    (f"{prefix}.{n}", opt.state[p]["exp_avg"] / (1 - beta1)
                     if "exp_avg" in opt.state.get(p, {}) else torch.zeros(()))
                    for n, p in module.named_parameters()))
    g0, d0 = weights(config, seed, device)
    change = _leaf_norms([(f"gen.{n}", p.detach() - g0[n]) for n, p in gen.named_parameters()]
                         + [(f"disc.{n}", p.detach() - d0[n])
                            for n, p in disc.named_parameters()])
    del g0, d0
    dev.synchronize()
    return dict(config=config, mix=mix, seed=seed, step=step, models=(gen, disc),
                opts=(g_opt, d_opt), pool=pool, checked=checked, grads=grads, change=change,
                step_flops=work.adversarial_step_flops(
                    config["batch_size"], config["samples"], config["widths"],
                    config["discriminator"]["periods"], config["discriminator"]["fft_sizes"]))


def window(state, seconds, spans):
    """Steps over the pool from where the checked steps stopped; the window
    ends when the loop stops issuing and the last step completes."""
    mix, pool, step = state["mix"], state["pool"], state["step"]
    limit = mix["trace_iterations"] if spans.traced else None
    queued = deque()
    dev.synchronize()
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds and (limit is None or i < limit):
        if len(queued) >= mix["in_flight"]:
            queued.popleft().synchronize()
        with spans.span("step"):
            metrics = step(pool[(mix["checked_steps"] + i) % len(pool)])
        queued.append(dev.event())
        i += 1
    dev.synchronize()
    elapsed = time.perf_counter() - start
    finite = all(bool(torch.isfinite(v)) for v in metrics.values()) if i else False
    clips = i * state["config"]["batch_size"]
    return {"attempted": i, "failed": 0 if finite else 1, "iterations": i,
            "model_flops": i * state["step_flops"],
            "metrics": {"train_clips_per_s": clips / elapsed}}


def reference_readings(config, mix, seed, pool, device, q=ref_dac.identity):
    """The reference's losses, first gradients and changes over the checked
    steps, from the same weights and batches; ``q`` rounds its products'
    operands (the control)."""
    gen, disc = weights(config, seed, device)
    g0 = {k: v.clone() for k, v in gen.items()}
    d0 = {k: v.clone() for k, v in disc.items()}
    opt = config["optimizer"]
    opt = dict(lr=opt["lr"], betas=tuple(opt["betas"]), eps=opt["eps"],
               weight_decay=opt["weight_decay"])
    g_state, d_state, losses = {}, {}, []
    for i in range(mix["checked_steps"]):
        out, g_grads, d_grads = ref.train_step(gen, disc, g_state, d_state, i + 1, pool[i],
                                               config["widths"], config["discriminator"], opt,
                                               config["sample_rate"], q)
        losses.append(out)
        if i == 0:
            grads = _leaf_norms([(f"gen.{k}", v) for k, v in g_grads.items()]
                                + [(f"disc.{k}", v) for k, v in d_grads.items()])
        del g_grads, d_grads
    change = _leaf_norms([(f"gen.{k}", gen[k] - g0[k]) for k in gen]
                         + [(f"disc.{k}", disc[k] - d0[k]) for k in disc])
    return losses, grads, change


def worst_leaf_gap(got, want, keep=None):
    """The largest gap between a leaf's norm on the two sides, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; and that leaf's name."""
    names = [k for k in want if keep is None or k in keep]
    median = float(np.median([want[k] for k in names]))
    return max((abs(got[k] - want[k]) / max(want[k], median, 1e-30), k) for k in names)


def _rel(a, b):
    return abs(a - b) / abs(b)


def numbers_of(readings):
    return {k: v for k, v in readings.items() if k != "look"}


def compare(program, reference):
    """The cell's numbers from the program's readings and the reference's
    (``(losses, grads, change)`` each), with what they were read from:
    the first step's losses (later steps' losses follow the leaves that
    round-off alone moves, through AdamW's normalised update), the first
    gradient's and the change's worst leaf."""
    (p_loss, p_grad, p_change), (r_loss, r_grad, r_change) = program, reference
    median_grad = float(np.median(list(r_grad.values())))
    # leaves that only round-off moves: their gradient is nought in the reference
    moved = {k for k, v in r_grad.items() if v >= 1e-3 * median_grad}
    grad_gap, grad_leaf = worst_leaf_gap(p_grad, r_grad)
    update_gap, update_leaf = worst_leaf_gap(p_change, r_change, keep=moved)
    return {
        "gen_loss1_rel": _rel(p_loss[0]["loss"], r_loss[0]["loss"]),
        "disc_loss1_rel": _rel(p_loss[0]["loss/discriminator"], r_loss[0]["loss/discriminator"]),
        "grad_gap": grad_gap,
        "update_gap": update_gap,
        "look": {"gen_loss_rel_by_step": [_rel(p["loss"], r["loss"]) for p, r in zip(p_loss, r_loss)],
                 "disc_loss_rel_by_step": [_rel(p["loss/discriminator"], r["loss/discriminator"])
                                           for p, r in zip(p_loss, r_loss)],
                 "grad_leaf": grad_leaf, "update_leaf": update_leaf,
                 "unmoved_leaves": sorted(set(r_grad) - moved)},
    }


def _reference(state):
    """Frees the program's models, then runs the reference in full fp32
    (kept for the control)."""
    if "reference" not in state:
        config, mix = state["config"], state["mix"]
        for key in ("step", "models", "opts"):
            state.pop(key, None)
        dev.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        state["reference"] = reference_readings(config, mix, state["seed"],
                                                state["pool"][: mix["checked_steps"]],
                                                dev.device())
    return state["reference"]


def control(state):
    """The control's numbers: the reference with every convolution's and
    dense layer's operands rounded to TF32 (the configuration states fp32
    with TF32 off) in the program's place."""
    config, mix = state["config"], state["mix"]
    reference = _reference(state)
    lower = reference_readings(config, mix, state["seed"], state["pool"][: mix["checked_steps"]],
                               dev.device(), q=rounding("tf32"))
    return numbers_of(compare(lower, reference))


def faults(state):
    """Each fault's numbers, planted in the reference in the program's
    place: half of every checked batch left out (the mean over the rest). A
    step that leaves its state unchanged reads 1 by the leaf measure and
    needs no run."""
    config, mix = state["config"], state["mix"]
    reference = _reference(state)
    half = [b[: b.shape[0] // 2] for b in state["pool"][: mix["checked_steps"]]]
    lower = reference_readings(config, mix, state["seed"], half, dev.device())
    return {"half_batch": numbers_of(compare(lower, reference))}


def check(state, window):
    mix = state["mix"]
    reference = _reference(state)
    numbers = compare((state["checked"], state["grads"], state["change"]), reference)
    state["look"] = numbers["look"]
    return [(name, numbers[name], limit) for name, limit in mix["limits"].items()]


def close(state):
    state.clear()
