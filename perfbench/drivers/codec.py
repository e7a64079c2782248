"""Driver of the codec round trip: one client sends one mono clip at a
time through ``models.artifacts.compress`` and then ``decompress``, the
codes on the host in between, as a user of the codec encodes and decodes.

Set-up builds the DAC without initializing it (``meta``), places it on the
card, loads weights made there from the seed, stages one seeded clip of
each of the mix's lengths, and runs every length once. The window is a
closed loop over the lengths in blocks that hold each once, each block in an
order drawn from the seed; a request's latency runs from issue to the
decoded audio after a synchronize. ``check`` compares, for requests the window finished (the
longest length and others drawn from the seed), the encoder's latents, the
codes and the decoded audio with the plain reference
(``reference/dac.py``) in full fp32.
"""
import math
import time

import numpy as np
import torch

from perfbench.drivers.train import load_weights
from perfbench.harness import device as dev
from perfbench.reference import dac as ref
from perfbench.reference.chain import rounding
from perfbench.traffic import clips as traffic
from perfbench.work import dac as work


def lengths(mix, hop):
    """The mix's request lengths in samples: log-evenly spaced between its
    shortest and longest seconds, each a multiple of ``hop``."""
    secs = np.geomspace(mix["min_seconds"], mix["max_seconds"], mix["n_lengths"])
    return [int(round(s * mix["sample_rate"] / hop)) * hop for s in secs]


def build(config, seed, device):
    from audiotools_tpu_torch.models import DAC

    with torch.device("meta"):
        model = DAC(**config["widths"], sample_rate=config["sample_rate"])
    model = model.to_empty(device=device).eval()
    load_weights(model, ref.make_weights(ref.param_specs(**config["widths"]), seed, device))
    return model


def request(state, k):
    """One round trip of clip ``k``: ``(latency s, codes, audio)``."""
    from audiotools_tpu_torch.models.artifacts import compress, decompress

    model = state["model"]
    start = time.perf_counter()
    artifact = compress(model, state["clips"][k])
    audio = decompress(model, artifact).audio_data
    dev.synchronize()
    return time.perf_counter() - start, artifact["codes"], audio


def setup(config, mix, seed, spans):
    device = dev.device()
    seed = int(seed)
    model = build(config, seed, device)
    hop = math.prod(config["widths"]["encoder_rates"])
    sizes = lengths({**mix, "sample_rate": config["sample_rate"]}, hop)
    seeds = traffic.sub_seeds(seed, len(sizes), salt=23)
    kinds = mix["kinds"]
    clips = []
    for i, (n, s) in enumerate(zip(sizes, seeds)):
        kind = traffic.GENERATORS[kinds[i % len(kinds)]]
        x = kind(s, n / config["sample_rate"] + 0.01, config["sample_rate"])[:n]
        clips.append(torch.from_numpy(x).to(device)[None, None])
    state = dict(config=config, mix=mix, seed=seed, model=model, clips=clips, sizes=sizes)

    def keep_latents(_module, _inputs, output):
        state["latents"] = output

    state["hook"] = model.encoder.register_forward_hook(keep_latents)
    for k in range(len(sizes)):  # every shape the window uses
        request(state, k)
    rng = np.random.default_rng([seed, 29])
    # every seed sends the same lengths, in its own order: blocks that hold
    # each length once
    blocks = -(-mix["max_requests"] // len(sizes))
    state["order"] = np.concatenate([rng.permutation(len(sizes)) for _ in range(blocks)])
    others = rng.choice(len(sizes) - 1, size=mix["judged_requests"] - 1, replace=False)
    state["judged"] = {len(sizes) - 1, *[int(k) for k in others]}
    state["flops"] = [work.codec_roundtrip_flops(n, config["widths"]) for n in sizes]
    return state


def window(state, seconds, spans):
    mix = state["mix"]
    limit = mix["trace_iterations"] if spans.traced else len(state["order"])
    latencies, kept, flops = [], {}, 0.0
    dev.synchronize()
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds and i < limit:
        k = int(state["order"][i])
        with spans.span("request"):
            latency, codes, audio = request(state, k)
        latencies.append(latency)
        flops += state["flops"][k]
        if k in state["judged"]:
            kept[k] = (codes, audio, state["latents"])
        i += 1
    state["kept"] = kept
    p95 = float(np.percentile(latencies, 95)) * 1e3 if latencies else float("nan")
    return {"attempted": i, "failed": 0, "iterations": i, "model_flops": flops,
            "metrics": {"codec_p95_ms": p95}}


def judge(w, clip, codes, audio, latents, rates):
    """The three numbers of one request: the latents' and the decoded
    audio's largest gap against the reference, relative to the reference's
    largest magnitude, and the widest gap by which a chosen code's
    similarity lies below the best code's in the reference."""
    with torch.no_grad():
        hop = math.prod(rates)
        x = torch.nn.functional.pad(clip, (0, (-clip.shape[-1]) % hop))
        want = ref.encode_latents(w, x, rates)
        latents_rel = float((latents - want).abs().max() / want.abs().max())
        codes = torch.as_tensor(np.asarray(codes, dtype=np.int64), device=want.device)
        code_gap, z_q = ref.code_gaps(w, want, codes)
        decoded = ref.decode(w, z_q, rates)[..., : clip.shape[-1]]
        audio_rel = float((audio - decoded).abs().max() / decoded.abs().max())
    return {"latents_rel": latents_rel, "code_gap": code_gap, "audio_rel": audio_rel}


def _free_program(state):
    if "hook" in state:
        state.pop("hook").remove()
    state.pop("model", None)
    state.pop("latents", None)
    dev.empty_cache()


def control(state):
    """The control's numbers: the reference with its products' operands
    rounded to TF32 (the configuration states strict fp32) in the program's
    place, judged by the fp32 reference."""
    config = state["config"]
    rates = config["widths"]["encoder_rates"]
    _free_program(state)
    w = ref.make_weights(ref.param_specs(**config["widths"]), state["seed"], dev.device())
    tf32 = rounding("tf32")
    worst = {}
    for k in sorted(state["kept"]):
        clip = state["clips"][k]
        hop = math.prod(rates)
        with torch.no_grad():
            x = torch.nn.functional.pad(clip, (0, (-clip.shape[-1]) % hop))
            latents = ref.encode_latents(w, x, rates, q=tf32)
            z_q, codes, _, _ = ref.quantize(w, latents, config["widths"]["n_codebooks"], q=tf32)
            audio = ref.decode(w, z_q, rates, q=tf32)[..., : clip.shape[-1]]
        for name, v in judge(w, clip, codes.cpu().numpy(), audio, latents, rates).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def check(state, window):
    config, mix = state["config"], state["mix"]
    _free_program(state)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = ref.make_weights(ref.param_specs(**config["widths"]), state["seed"], dev.device())
    worst = {}
    for k, (codes, audio, latents) in sorted(state["kept"].items()):
        numbers = judge(w, state["clips"][k], codes, audio, latents,
                        config["widths"]["encoder_rates"])
        for name, v in numbers.items():
            worst[name] = max(worst.get(name, 0.0), v)
    if not worst:
        return [(name, float("inf"), limit) for name, limit in mix["limits"].items()]
    return [(name, worst[name], limit) for name, limit in mix["limits"].items()]


def close(state):
    state.clear()
