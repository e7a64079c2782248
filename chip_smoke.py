"""Smoke run of the PyTorch port's paths on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``audiotools_tpu_torch/csrc`` and
runs, on card 0:

1. the device, its name and power limit (``nvidia-smi``), the kernel build
   (one nvcc per source, all at once, with ptxas's registers and spills),
   and the default device of signals and loaders (the card);
2. kernel A (per-item causal FIR) against its plain PyTorch version at the
   equalizers' shapes (64 rows of 5 s or 1 s at 44.1 kHz; 641 or 231 taps);
3. kernel B (fused phase vocoder) against its plain version at the pitch
   shift's shape (64 x 1 x 1025 bins, 384 frames -> 432 steps), read in
   place from a time-major spectrum as the chains give it, in both
   variants: with the phasor track and without it (the chains' launch,
   which the kernel table reports);
4. kernel C (causal FIR, one shared kernel) at the FIR meter's shapes
   (64 or 128 rows of 5 s, 1023 or 4095 taps) and at its 8192-tap limit;
   kernel D (exclusive complex cumprod) at 65,600 rows x 432 steps; kernel
   E (fused bf16 iSTFT synthesis) at the pitch shift's synthesis (64 x 432
   frames of 2048, hop 512) and at n_fft 512, hop 128, with its
   peak-memory increment against ``istft(method="matmul_bf16")``, with and
   without ``match_stride``; kernel F (the exact meter's block-state
   recurrence) at the meter's 64 and 128 rows x 431 blocks x 4 states, in
   fp32 and fp64, against its plain version, the loop of one ``addmm`` a
   block that it replaced, and one exact meter call of 128 rows through
   each: host time to enqueue, device time and device operations; then
   kernel G (DAC's Snake) forward and backward at the codec decoder's last
   Snake at 30 s, the training cell's first and its deepest, against the
   eager expression and autograd's backward of it, with the memory autograd
   keeps for one Snake under each; then kernel D's own path, its public
   entry point ``rotation_cumprod`` (no library path calls it), with its
   launches counted;
5. three paths on a staged batch of 64 clips of 5 s at 44.1 kHz
   (AudioDataset -> DataLoader -> Compose(RoomImpulseResponse,
   BackgroundNoise, Equalizer, VolumeNorm) -> pitch_shift(+2 st) -> mel-80
   -> BS.1770 loudness), each timed per stage with CUDA events, with its
   peak memory, and checked to have launched its kernels: the main path
   (exact meter, bf16 synthesis: A, B and F), the reference-parity path (the
   FIR meter of ``set_fast_meter(True)`` and the fused synthesis: A, B, C
   and E), and the original-phase path (the main path with
   ``RoomImpulseResponse(use_original_phase=True)``: the wet magnitude on
   the dry STFT phase; its own dataset and staged batch, the same clips;
   A, B and F);
6. the same chains on the card and on the CPU (plain versions) for the
   first 4 clips, against stated tolerances on every sample; the
   original-phase path also on a copy of its clips led by 0.25 s of exact
   zeros (digital silence);
7. the differentiable pitch shift on the staged batch (64 x 5 s, +2 st):
   the gradient of a scalar loss through ``pitch_shift(pv_formulation=
   "phasor_fused")`` (kernel B with its phasor track under the forward, the
   custom backward) against autograd of the ``phasor`` formulation, and the
   same at the vocoder alone, each timed forward + backward;
8. codec training at full width: ``DAC()`` and ``Discriminator()`` at their
   defaults (seeded weights), a batch of 16 x 16,896 samples (33 hops of
   512) from ``AudioDataset`` / ``DataLoader`` over the fixture tree, 3
   reconstruction steps (``make_train_step``) and 3 adversarial steps
   (``make_adversarial_train_step``), the first of each untimed, at torch's
   default TF32 settings: ms/step, clips/s and peak memory; then one more
   step of each under ``torch.profiler`` (device idle share, the kernels
   that take the most time);
9. one step of each on the card and on the CPU at batch 2 from the same
   weights, inside ``strict_fp32``: losses, the generator's gradient norm,
   the parameters after the update, the encoder's latents, the decoder on
   the same codes, and the code agreement (reported);
10. the augmentation zoo: 64 clips of 5 s from AudioDataset -> DataLoader
   (8 workers; every parameter, loaded signal and noise plane drawn on the
   host) through a Compose of every leaf transform, probabilities below 1
   mixing the masks within the batch, run 6 times (the first through
   ``Compose.transform``, untimed; then child by child, as Compose runs
   them, with CUDA events between): ms a batch per transform and for the
   chain, peak memory and kernel A's launches (its equalizers); then each
   transform on the card and on the CPU for the first 4 clips from the same
   input, against stated tolerances;
11. multitrack: a seeded chord fixture (``util.generate_chord_dataset``, 64
   tracks of up to 4 sine voices, 5 s) loaded as an aligned two-voice
   ``AudioDataset`` through ``DataLoader(sampler=ResumableSequentialSampler,
   drop_last=True, num_workers=8, wire_dtype="int16")``; on the card, the
   voices dequantized and summed, then at time-stretch factors 1.25 and 0.8
   (``pv_formulation="phasor_fused"``: kernel B) the equalizer with a
   per-item curve (``conv_method="pallas"``: kernel A), ``split_bands(6)``,
   the K-weighting ``biquad_cascade``, ``mfcc(40, 80)``, a ``collect_windows``
   / ``overlap_and_add`` round trip, and two items written and read back:
   ms and peak memory per stage; kernels B and A against their plain
   versions at the path's shapes; the path on the card against the CPU for
   the first 4 clips;
12. serving and evaluation: ``DAC()`` at its defaults (seeded weights)
   through ``save_to_folder`` and ``load_from_folder`` (weights bit-equal),
   8 clips of 30 s at 44.1 kHz (2,584 code frames each) through
   ``compress`` whole and streamed (128-frame chunks), a
   ``StreamingEncoder`` fed in irregular blocks, the artifact's save and
   load, ``decompress`` whole and streamed: ms, real-time factor and peak
   memory of each, streamed against whole (codes equal, audio within 2e-6),
   and the whole passes' convolution throughput and profiled kernels; then
   the 8 (original, reconstruction) pairs through ``stoi_device`` (plain and
   extended), ``pesq_device(mode="wb")`` and ``visqol(backend="nsim")`` in
   its audio and speech modes: ms and pairs/s; items 0-1 through the same
   entry points on the CPU (codes, audio beside the card's float64 decode,
   scores, PESQ's delays and STOI's retained frames) and against the
   float64 host STOI and native PESQ, on the reconstructions and on a
   20 dB-SNR control pair. This path runs kernel G (the DAC's Snakes)
   alone;
13. the training loop: ``python -m audiotools_tpu_torch.examples.train_dac``'s
   ``main`` at ``DAC()`` + ``Discriminator()`` full width, batch 16 x 16,384
   samples from the fixture tree (``AudioDataset`` over 4 loader workers,
   ``Compose(VolumeNorm, LowPass, ClippingDistortion)`` on the card): 6
   adversarial steps in fp32 with the ``Tracker`` and the loop's
   ``Checkpointer`` (keeping 3), saving every 3 steps; fresh models, optimizers and tracker
   restored from step 3 and run to 6 (the restored state bit-equal to the
   saved one, fed the same dataset indices as steps 4-6); 3 steps with
   ``--amp`` (bf16); one step under ``ml.profiling.trace``: ms per step (CUDA
   events, each loop's first step apart), the share of each step's wall time
   spent waiting on the loader and the loader's host spans
   (``data.hostprof``), the checkpoint's size and its save and restore
   seconds, peak memory in fp32 and bf16, and one more step of the fp32
   and the bf16 loop under ``torch.profiler`` (device idle share, the
   kernels that take the most time). This path runs none of the five
   ported TPU kernels; its exact meters (``VolumeNorm``) launch kernel F,
   its fp32 DAC's Snakes kernel G.
14. host I/O and codecs: the native WAV, FLAC and libav libraries built
   with g++ from ``audiotools_tpu_torch/native`` (seconds each), the system
   codec libraries present (mp3, vorbis, vorbis-encode, gsm, av, and the
   ``ffmpeg`` binary), 64 clips of 5 s at 44.1 kHz written in every format
   present (WAV PCM_16 and FLOAT, FLAC 16- and 24-bit, MP3, Ogg, M4A), each
   loaded through ``AudioDataset`` -> ``DataLoader`` (8 worker threads) onto
   the card: first batch's seconds and clips/s by host clock, the card's
   batch against the CPU's decode and the lossless formats against the
   source's quantization, bit for bit; ``native.read_batch`` against
   per-file ``read_wav``; every ``apply_codec`` preset (8-bit, MP3, Vorbis,
   Ogg, GSM-FR, Amr-nb) on the staged batch: ms a batch by host clock, the
   device part (the resamples) by CUDA events, the card against the CPU (bit
   for bit through the file codecs, stage by stage around the telephone
   codecs); the ffmpeg mixin's routes on the card (``ffmpeg_loudness``,
   ``ffmpeg_resample``, ``load_from_file_with_ffmpeg``) and ``write`` in
   every format from a card signal, read back. A format or preset whose
   system library is absent is printed as absent and not run. This path
   runs none of the five ported TPU kernels; its exact meters launch
   kernel F.
15. the long signal (``audiotools_tpu_torch.parallel``): one hour of
   stereo at 44.1 kHz made on the card from a seed, at world size 1 under
   ``nccl`` (``make_mesh({"sp": 1})``): the sharded K-weighting FIR,
   resample to 16 kHz, meter and (one channel, window 2048, hop 1024) STFT
   and iSTFT, each timed by CUDA events with its peak memory and held to
   its single-device op on the card, the meter also to the FIR meter of
   ``set_fast_meter(True)`` (kernel C). The multi-rank halo exchange runs
   in the CPU tests (``gloo`` cannot carry card tensors point to point,
   and NCCL refuses two ranks on one card). This path runs none of the
   five kernels;
16. the codec example: ``python -m audiotools_tpu_torch.examples.codec
   --toy`` compress then decompress on the card. Kernel G (the Snakes)
   alone launches;
17. model-parallel training at full width: phase 8's ``DAC()`` and
   ``Discriminator()`` (the same seeded weights) through ``models.train.
   shard_params`` on a ``{"dp": 1, "tp": 1}`` mesh at world size 1 under
   ``nccl``, 3 reconstruction and 3 adversarial steps on phase 8's batch
   (the first of each untimed): ms/step, clips/s and peak memory beside
   phase 8's unsharded step, and one more step under ``torch.profiler``
   (device idle share); inside ``strict_fp32`` one step of each,
   sharded against unsharded from the same weights (losses, the parameters
   after the update, within ``TRAIN_TOL``); the sharded state of both
   models and both optimizers through ``Checkpointer``, restored into fresh
   sharded models bit for bit with its placements. This path runs kernel G
   (the Snakes) alone. The multi-rank (dp, tp) path runs on the CPU tests and
   across cards in ``tests/test_torch_cuda.py``;
18. accounting (``ops.perf``, ``ops.benchmark``): each kernel at its
   main-path shape timed by ``device_time`` (CUDA events, 10 then 20
   calls) and ``device_time_stats`` beside ``time_ms``, its ``xla_cost``
   (the kernel launched once) equal to its registered work; the two
   training steps of phase 8 on fresh seeded models, the reconstruction
   step by ``device_time_stats(iters=5, repeats=3)`` and the adversarial
   step by ``device_time_queued`` (fetching the loss), each with ``mfu``
   from the analytic counters and ``mfu_xla`` / ``hbm_frac`` from one
   step's ``xla_cost``, whose FLOPs must lie within 1-3x the analytic
   core; a ``stage_roofline`` row for each stage of the main chain
   (transforms, pitch shift, mel, loudness) and the chain's ``summarize``;
   the same kernel timers at the kernel table's other rows (A and B at the
   multitrack shapes, B with its phasor track); every line with the card's
   name and power limit;
19. the single-pass bf16 analysis (``stft(method="matmul_bf16")``): the
   adversarial step of phase 8 with ``Discriminator(stft_method=
   "matmul_bf16")`` beside the fp32 one (one pair of seeded models each,
   ``BF16_TRAIN_TURNS`` alternating turns): median ms/step, clips/s, peak
   over the resident models, each step's profiled idle share, and the
   ratios of bf16 to fp32; one bf16 step on the card
   and on the CPU at batch 2 in strict fp32 (``TRAIN_TOL``); the analysis
   alone at the main path's shape (64 x 220,500, 2048 / 512) timed in
   turns with ``"matmul"``, card against CPU and against the fp32 spectrum;
   ``MelSpectrogramLoss`` + ``MultiScaleSTFTLoss`` with the bf16 analysis
   on the training batch, value and gradient norm card against CPU; and
   the JAX package's interpreter-mode names (the meter's
   ``"pallas_interpret"``, ``"phasor_fused_interpret"``,
   ``"matmul_bf16_fused_interpret"``) on the card, bit for bit against
   their kernels' plain versions, with no launch. This path runs none of
   the five kernels.

Every kernel is also held against its plain version at ragged shapes of
its tiling (B and D bit for bit), and timed beside its bound (the larger
of its operations over the card's peak rate for their type and its bytes,
each input read once and each output written once, over the memory rate)
and beside the one PyTorch call that computes the same function, where
there is one (the port never calls it); the bound's flops and bytes are the
wrapper's registered work (``wrapper.work``, what ``ops.perf.xla_cost``
counts for it), and each kernel's row carries phase 18's ``device_ms``
beside ``ms``. Any failed check exits non-zero.
The last lines are the kernel table, the card's name and power limit, and
``{"ok": true, "device": ...}``. Without a CUDA device the script exits
non-zero and prints no result.
"""
import contextlib
import copy
import csv
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from audiotools_tpu_torch.ops import perf as PERF

SR = 44100
BATCH = 64
DURATION = 5.0
N_ITER = 5
N_CHECK = 4

# published peaks of an H100 SXM (dense): fp32 outside the tensor cores;
# bf16 tensor cores and HBM3 from the port's accounting (ops/perf.py)
FP32_FLOPS = 67e12
BF16_FLOPS = PERF.PEAK_BF16_FLOPS
HBM_BYTES = PERF.HBM_BYTES_PER_S

# kernel vs plain version on the card, relative to the largest output. All
# sum in fp32; E rounds its operands to bf16 as its plain version does and
# sums the exact products in another order (measured 2e-6)
KERNEL_RTOL = 1e-5
# chain on the card vs on the CPU (first N_CHECK clips). With fp32
# synthesis both sides sum in fp32 in different orders. With the path's
# bf16 synthesis, a spectrum value that lies within fp32 rounding of a bf16
# rounding boundary goes to different bf16 neighbours on the two sides,
# which moves it by one bf16 ulp, 2**-8 ~ 3.9e-3 of itself: the bound for
# the largest outputs.
# kernel E's peak-memory increment at the chain's shape: its output (57 MB)
# and nothing of the size of the spectrum or the frames
E_PEAK_LIMIT = 60e6
CHAIN_TOL = {
    "matmul": {"audio_abs": 1e-4, "mel_rel": 1e-4, "lufs_db": 0.01},
    "matmul_bf16": {"audio_abs": 4e-3, "mel_rel": 4e-3, "lufs_db": 0.01},
}
# the differentiable vocoder (R4): the fused gradient against the phasor
# formulation's, relative to the largest gradient; at the vocoder the JAX
# package's pin (docs/perf.md), through the whole pitch shift its test's
# (tests/core/test_stretch.py::test_pitch_shift_fused_is_differentiable)
PV_GRAD_RTOL = 4.4e-5
PITCH_GRAD_RTOL = 1e-4

# codec training: BASELINE config 5's batch, 16 clips of 33 hops of 512
TRAIN_BATCH = 16
TRAIN_SAMPLES = 33 * 512
TRAIN_STEPS = 3  # the first untimed
TRAIN_CHECK_BATCH = 2
LR = 1e-4
# one step on the card against the CPU, both in full fp32. Forward values
# and losses: fp32 sums in other orders (cuDNN's algorithms) through ~60
# layers. The gradient norm: the log-magnitude losses weigh quiet bins by
# 1 / |X| and magnify rounding there (tests/test_torch_losses.py). After one
# AdamW step each parameter moves by about LR; a gradient within rounding of
# zero may flip its sign and move by 2 LR the other way, so at most one
# entry in 1000 may differ by more than 1e-3 LR, and none by more than 2 LR.
TRAIN_TOL = {"latent_rel": 1e-4, "decoded_rel": 1e-4, "loss_rel": 1e-4,
             "grad_norm_rel": 1e-3, "update_lr": 1e-3, "update_share": 1e-3}

# the augmentation zoo, card vs CPU on the same input, each transform alone.
# Every transform: max abs error on the audio, the chain's fp32 bound above
# (FFTs, kernel A and the meters sum in other orders on the two sides). The
# quantizers move a sample by a whole level when their input lies within
# rounding of a level's edge ((x + 1) / 2 q, and mu-law's log1p and exp,
# round differently on the card), so they are judged by the share of
# samples differing by more than that bound. TimeNoise and FrequencyNoise
# fill every cell whose magnitude and phase are 0, as the JAX package does,
# so also a cell that was exactly zero before their mask: the phase of an
# exactly-zero cell reads 0 on both devices, whatever sign cuFFT or the
# CPU's FFT gave its zeros, so frames of digital silence are filled alike.
# In frames of few distinct values (the quantizers make them) one FFT may
# cancel to an exact zero where the other leaves a rounding residue. Their
# bound holds outside the frames that hold a cell the fill reads as empty
# on one device and not on the other.
ZOO_RUNS = 6  # the first through Compose.transform, untimed
ZOO_ABS = 1e-4
ZOO_SHARE = 1e-3

# multitrack: two aligned voices of the chord fixture, two stretch factors,
# a 6-band EQ curve per item, and the chain's bounds card vs CPU, each stage
# on both devices from the CPU's output of the stage before: audio (fp32 sums
# in other orders) 1e-4 abs, the mel and the MFCCs' log-DCT 1e-4 of their
# largest magnitude, and on each device the bands' sum equal to their input
# within 1e-6 abs (the JAX package's partition-of-unity pin,
# tests/parity/test_parity.py). The dequantized mix and the vocoder on one
# spectrum (kernel B against its plain version on the CPU) must be equal
# bit for bit; the STFT is held within 1e-5 of its largest magnitude
# (2048-term fp32 sums in other orders). Two composites are reported, not
# held, because the fixture makes them ill-conditioned (PERF.md, section 6):
# the whole stretch (pure sines leave bins at fp32's rounding floor for
# hundreds of frames, where the vocoder's phase is a random walk of
# rounding in either formulation, and a voice's abrupt end puts energy into
# them) and the whole MFCC (its log turns the two FFTs' rounding floors, in
# the bands that pure tones and digital silence leave near the 1e-6 log
# offset, into differences of order one)
MT_VOICES = ("voice_0", "voice_1")
MT_FACTORS = (1.25, 0.8)
MT_BANDS = 6
MT_MFCC = (40, 80)
MT_WINDOW = (1.0, 0.5)  # seconds: window, hop
MT_TOL = {"mix_abs": 0.0, "stft_rel": 1e-5, "vocoder_abs": 0.0, "istft_abs": 1e-4,
          "eq_abs": 1e-4, "bands_abs": 1e-4, "bands_sum_abs": 1e-6, "weighted_abs": 1e-4,
          "windows_abs": 1e-4, "mel_rel": 1e-4, "log_dct_rel": 1e-4}

# serving and evaluation: DAC() at its defaults (seeded weights) saved and
# loaded back, 8 clips of 30 s at 44.1 kHz (2,584 code frames each)
# compressed and decompressed whole and through 128-frame windows, and the
# 8 (original, reconstruction) pairs scored. Streamed against whole: codes
# equal, audio within 2e-6 (the JAX package's pin,
# tests/models/test_streaming.py). A code that differs counts against the
# check only where the whole pass's two best codeword similarities at the
# frame's first differing stage lie more than 1e-5 apart (relative): inside
# that gap fp32 rounding decides; the encoder's latents are held within 1e-5
# of their largest value. Card against CPU on items 0-1 (SERVE_CHECK): codes
# as above; the scores at the JAX package's pins (STOI 5e-4, PESQ 2e-3 MOS,
# NSIM 1e-4), PESQ's delays and STOI's retained-frame counts equal; the decoded
# audio, a forward pass through ~50 layers in fp32 in other orders on the two
# devices, within 1e-5 of its largest value (tests/test_torch_models.py's
# FWD_RTOL), each device also that close to the card's float64 decode. The
# float64 host STOI and native PESQ on items 0-1 are the oracle, at the same
# pins, on the reconstructions and on a control pair (each clip at 20 dB
# SNR); device PESQ reproduces the host's trim where the delay is not
# negative (or a whole number of hops), its framing phase otherwise
# (ops/pesq.py), so it is held there.
SERVE_MODEL = {}  # DAC()'s defaults
SERVE_BATCH = 8
SERVE_SECONDS = 30.0
SERVE_CHUNK = 128
SERVE_CHECK = 2
SERVE_BLOCKS = (0.1, 0.7)  # seconds: the StreamingEncoder's push sizes
SERVE_TOL = {"audio_abs": 2e-6, "margin_rel": 1e-5, "latent_rel": 1e-5, "device_rel": 1e-5,
             "stoi": 5e-4, "pesq": 2e-3, "nsim": 1e-4}

# phase 13: the canonical training loop at full width (its own defaults:
# 0.38 s at 44.1 kHz, rounded down to the hop, is 16,384 samples)
LOOP_BATCH = 16
LOOP_WORKERS = 4
LOOP_STEPS = 6
LOOP_CKPT_EVERY = 3
LOOP_AMP_STEPS = 3

# phase 14: host I/O and codecs. 64 clips of 5 s at 44.1 kHz in every format
# the machine can write, each loaded through AudioDataset -> DataLoader (8
# worker threads) onto the card, and the staged batch through every
# apply_codec preset. Decoding is host code, so the card's batches equal the
# CPU's decode bit for bit, and WAV and FLAC the int16/int24 (or float32)
# quantization of the source. MP3, Vorbis and Ogg give the card's batch the
# CPU's bits (the host codec gets the same bytes). GSM-FR and Amr-nb are held
# stage by stage from one input: the 8 kHz resample on the card within the
# resample's 1e-5 pin (tests/test_torch_ops.py) of the CPU's, the codec fed
# the card's 8 kHz audio equal to the preset on the card, the resample back
# within 1e-5. The 8-bit preset is mu-law: samples within rounding of a
# level's edge move by a level, so it is judged as the zoo's quantizers are.
# ffmpeg_loudness meters a 16-bit file of each item: equal within 1e-4 dB to
# loudness() of that file, within 0.2 dB (the JAX package's pin) of the
# in-memory loudness
IO_BATCH = 64
IO_SECONDS = 5.0
IO_WORKERS = 8
IO_FORMATS = (("wav_pcm16", ".wav", "PCM_16"), ("wav_float", ".wav", "FLOAT"),
              ("flac16", ".flac", "PCM_16"), ("flac24", ".flac", "PCM_24"),
              ("mp3", ".mp3", None), ("ogg", ".ogg", None), ("m4a", ".m4a", None))
IO_PRESETS = ("8-bit", "MP3", "Vorbis", "Ogg", "GSM-FR", "Amr-nb")
IO_TOL = {"resample_abs": 1e-5, "lufs_db": 1e-4, "lufs_file_db": 0.2}

# the long signal: one hour of stereo at world size 1 under nccl (NCCL refuses
# two ranks on one card, and gloo cannot carry card tensors point to point:
# its TCP transport reads them as host memory and raises "Bad address", so
# the multi-rank halo logic runs in the CPU tests' gloo processes). Each
# sharded op against its single-device counterpart on the same input, at
# the JAX package's pins for the same comparison
# (tests/parallel/test_timeshard.py: FIR 1e-4, STFT 1e-5 of its scale,
# iSTFT 1e-5 and round trip 1e-4, resample 1e-6, loudness 1e-5 LU against
# the exact meter; the FIR meter of set_fast_meter(True) truncates each
# stage to 512 taps, so against it the signal API's pin,
# tests/parallel/test_signal_api.py, 1e-3 LU). The STFT runs hop 1024: with
# one shard the center-padding rule n_dev * hop >= window / 2 refuses
# 2048/512.
LONG_SECONDS = 3600.0
LONG_WINDOW = 2048
LONG_HOP = 1024
LONG_RATE = 16000
LONG_TOL = {"fir_abs": 1e-4, "stft_rel": 1e-5, "istft_abs": 1e-5, "round_trip_abs": 1e-4,
            "resample_abs": 1e-6, "lufs_exact_db": 1e-5, "lufs_fir_meter_db": 1e-3}

# accounting (phase 18): the kernels' two-point timers over 10 and 20 calls
# (the stats the median of 5 pairs); the training steps timed as bench.py
# times the JAX steps (5 and 10 steps, the reconstruction step's median of
# 3 pairs); a step's counted FLOPs (ops.perf.xla_cost) at least its analytic
# core and at most 3x it (tests/test_perf_accounting.py's upper bound: the
# count adds the losses' matmul STFTs and the MRD's matmul DFT)
ACCT_KERNEL_ITERS = 10
ACCT_KERNEL_REPEATS = 5
ACCT_STEP_ITERS = 5
ACCT_STEP_REPEATS = 3
ACCT_FLOP_BAND = (1.0, 3.0)
ROOFLINE_KEYS = {"stage", "ms", "gbytes", "hbm_frac", "gflops", "mfu_xla"}


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


FAILED = []  # failed expectations: the run goes on and exits non-zero at the end


def expect(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        FAILED.append(msg)


# ---------------------------------------------------------------------------
# fixtures: deterministic speech-like, noise and impulse-response WAVs
# ---------------------------------------------------------------------------


def speech_like(seed, duration=12.0):
    rng = np.random.RandomState(seed)
    n = int(duration * SR)
    t = np.arange(n) / SR
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.4 * t + rng.rand() * 6)
    phase = np.cumsum(2 * np.pi * f0 / SR)
    sig = np.zeros(n)
    for h, a in [(1, 1.0), (2, 0.6), (3, 0.4), (4, 0.25), (5, 0.12)]:
        sig += a * np.sin(h * phase + rng.rand() * 6)
    noise = rng.randn(n) * 0.15
    am = 0.5 * (1 + np.sin(2 * np.pi * 2.5 * t + rng.rand() * 6))
    am = am * (rng.rand(n) < 0.999)
    return ((sig * am + noise * am) * 0.15).astype(np.float32)


def noise_like(seed, duration=12.0):
    rng = np.random.RandomState(seed)
    b = np.exp(-np.arange(64) / 16.0)
    return (np.convolve(rng.randn(int(duration * SR)), b / b.sum(), mode="same") * 0.2).astype(np.float32)


def ir_like(seed, duration=1.0):
    rng = np.random.RandomState(seed)
    n = int(duration * SR)
    out = np.zeros(n, dtype=np.float32)
    out[64] = 1.0
    out[65:] = 0.25 * rng.randn(n - 65) * np.exp(-np.linspace(0, 9, n - 65))
    return out


def build_fixture_tree(root: Path):
    from audiotools_tpu_torch.io import write_wav

    groups = {
        "spk": [speech_like(i) for i in range(3)],
        "nz": [noise_like(100 + i) for i in range(2)],
        "ir": [ir_like(200 + i) for i in range(2)],
    }
    for name, sigs in groups.items():
        (root / name).mkdir()
        with open(root / f"{name}.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["path"])
            writer.writeheader()
            for i, s in enumerate(sigs):
                path = root / name / f"{name}_{i}.wav"
                write_wav(path, s[None, :], SR)
                writer.writerow({"path": str(path)})


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, n):
    """Mean milliseconds per call of ``fn`` over ``n`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(flops, peak, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def yardsticks(ms, flops, peak, nbytes, library=None, library_fn=None, n_library=3):
    """The kernel line's keys for one shape: bound, what bounds it, the share
    of it reached, and the library call's time (``library_fn``, timed here)."""
    bound_ms, bound_by = bound(flops, peak, nbytes)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "library": library,
            "library_ms": time_ms(library_fn, n_library) if library_fn is not None else None}


def compare_kernel(name, kernel, plain, n_kernel, n_plain):
    """Kernel vs plain on the same inputs: error and times, measured in
    turns (plain, kernel, kernel, plain)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    expect(all(bool(torch.isfinite(g).all()) for g in got), f"{name}: non-finite output")
    p1 = time_ms(plain, n_plain)
    k1 = time_ms(kernel, n_kernel)
    k2 = time_ms(kernel, n_kernel)
    p2 = time_ms(plain, n_plain)
    return abs_err, rel_err, (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    from audiotools_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    expect(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = (smi.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {card}")
    t0 = time.perf_counter()
    _build.build_all()  # one nvcc per source, all started together
    print(f"[build] all sources: {time.perf_counter() - t0:.2f} s")
    for source in _build.SOURCES:
        ptxas = [ln.split(":", 1)[-1].strip() for ln in _build.build_log(source).splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"[build] {source}: nvcc {_build.BUILD_SECONDS.get(source, 0.0):.2f} s "
              f"{' | '.join(ptxas)}")
    return card


def phase_defaults():
    """Signals built from arrays go to the card unless told ``device="cpu"``;
    tensors stay where they are."""
    from audiotools_tpu_torch import AudioSignal

    x = np.zeros((1, 1, 100), np.float32)
    devices = (AudioSignal(x, SR).device.type, AudioSignal(x, SR, device="cpu").device.type,
               AudioSignal(torch.from_numpy(x), SR).device.type)
    print(f"[defaults] AudioSignal from numpy: {devices[0]}; with device='cpu': {devices[1]}; "
          f"from a CPU tensor: {devices[2]}")
    expect(devices == ("cuda", "cpu", "cpu"), f"default devices {devices}")


def phase_kernel_a(dev):
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    rng = np.random.RandomState(1)
    results = {}
    # (rows, padded length, taps): Equalizer, noise EQ (3 bands), IR EQ
    for label, (rows, T, L) in {
        "equalizer": (BATCH, int(SR * DURATION) + 640, 641),
        "noise_eq": (BATCH, int(SR * DURATION) + 230, 231),
        "ir_eq": (BATCH, SR + 640, 641),
    }.items():
        x = torch.from_numpy(rng.randn(rows, T).astype(np.float32)).to(dev)
        h = torch.from_numpy((rng.randn(rows, L) * 0.05).astype(np.float32)).to(dev)
        abs_err, rel_err, ms, plain_ms = compare_kernel(
            "fir_causal_batch", lambda: HK.fir_causal_batch(x, h),
            lambda: HK.fir_causal_batch_plain(x, h), 10, 3,
        )
        work = HK.fir_causal_batch.work(x, h)
        gflop = work["flops"] / 1e9
        xpad, hflip = F.pad(x, (L - 1, 0))[None], h.flip(-1)[:, None, :].contiguous()
        with strict_fp32():
            yard = yardsticks(ms, work["flops"], FP32_FLOPS, work["bytes"],
                              "F.conv1d (cuDNN, TF32 off)",
                              lambda: F.conv1d(xpad, hflip, groups=rows))
        print(f"[kernel A] {label} ({rows}, {T}) x {L} taps: max_abs_err {abs_err:.3e} "
              f"rel {rel_err:.3e} (tol {KERNEL_RTOL:g}) | kernel {ms:.4f} ms "
              f"({gflop / ms:.2f} TFLOP/s) | plain {plain_ms:.4f} ms | bound "
              f"{yard['bound_ms']:.4f} ms ({yard['bound_by']}, {yard['share_of_bound']:.1%}) | "
              f"{yard['library']} {yard['library_ms']:.4f} ms")
        expect(rel_err < KERNEL_RTOL, f"kernel A disagrees with its plain version ({label})")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)
    return results


def pv_main_case(dev):
    """Kernel B's input at the pitch shift's shape, (64, 1, 1025, 384) at +2
    semitones -> 432 steps: a spectrum that is a transposed view of a
    time-major tensor (as ``ops.fft.stft`` returns it) and its step tables."""
    from audiotools_tpu_torch.ops import stretch as PS

    rng = np.random.RandomState(2)
    tm = (BATCH, 1, 384, 1025)
    z = torch.from_numpy(
        (rng.randn(*tm) + 1j * rng.randn(*tm)).astype(np.complex64)
    ).to(dev).transpose(-1, -2)
    return (z, *PS._pv_indices(tm[2], 2.0 ** (-2.0 / 12.0)))


def rotation_main_case(dev):
    """Kernel D's input at the pitch shift's rows x steps, 65,600 x 432:
    unit rotations and seeds as real planes ``(ur, ui, cr, ci)``."""
    rng = np.random.RandomState(4)
    rows, n = BATCH * 1025, 432
    ang = rng.uniform(-np.pi, np.pi, (rows, n))
    seed = rng.uniform(-np.pi, np.pi, rows)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        np.cos(ang), np.sin(ang), np.cos(seed), np.sin(seed)))


def phase_kernel_b(dev):
    """Kernel B at the pitch shift's shape, as the chains launch it: on a
    time-major spectrum read in place, in both variants: without the phasor
    track (the path's) and with it (the forward of the differentiable
    vocoder). Each is held bit for bit against its plain version and timed
    beside its own bound."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    z, i0, i1, frac = pv_main_case(dev)
    shape = tuple(z.shape)
    rows, n = int(np.prod(shape[:-1])), len(i0)
    results = {}
    for label, with_phasor in (("with_phasor", True), ("path", False)):
        abs_err, _, ms, plain_ms = compare_kernel(
            "phase_vocoder_fused",
            lambda: HK.phase_vocoder_fused(z, i0, i1, frac, with_phasor=with_phasor),
            lambda: HK.phase_vocoder_fused_plain(z, i0, i1, frac, with_phasor=with_phasor), 10, 2,
        )
        work = HK.phase_vocoder_fused.work(z, i0, i1, frac, with_phasor)
        nbytes = work["bytes"]
        yard = yardsticks(ms, work["flops"], FP32_FLOPS, nbytes)
        plan = HK.pv_plan(rows, with_phasor)
        sync = f"a barrier every {plan.sync_every} steps" if plan.sync_every else "no barrier"
        print(f"[kernel B] {shape} -> {n} steps, {label} (plan {plan.threads} threads, "
              f"frames {plan.depth} steps ahead, {sync}): max_abs_err "
              f"{abs_err:.3e} (must be 0) | kernel {ms:.4f} ms ({nbytes / ms / 1e9:.2f} TB/s) | "
              f"plain {plain_ms:.4f} ms | bound {yard['bound_ms']:.4f} ms ({yard['bound_by']}, "
              f"{nbytes / 1e6:.1f} MB, {yard['share_of_bound']:.1%})")
        expect(abs_err == 0.0, f"kernel B ({label}) differs from its plain version")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)
    print("[kernel B] library: none; no PyTorch call computes the phasor vocoder's "
          "step recurrence")
    return results


def phase_kernel_c(dev):
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    rng = np.random.RandomState(3)
    n = int(SR * DURATION)
    meter = {z: PL._composed_fir(SR, "K-weighting", z) for z in (512, 2048)}
    results = {}
    # (rows, T, taps): the final LUFS and VolumeNorm; BackgroundNoise's
    # stacked signal + noise call; the zeros=2048 meter; the 8192-tap limit
    for label, (rows, T, h) in {
        "meter": (BATCH, n, meter[512]),
        "meter_stacked": (2 * BATCH, n, meter[512]),
        "meter_zeros2048": (BATCH, n, meter[2048]),
        "max_taps": (8, SR, (rng.randn(HK.MAX_TAPS) * 0.01).astype(np.float32)),
    }.items():
        L = len(h)
        x = torch.from_numpy(rng.randn(rows, T).astype(np.float32) * 0.1).to(dev)
        ht = torch.from_numpy(h).to(dev)
        abs_err, rel_err, ms, plain_ms = compare_kernel(
            "fir_causal", lambda: HK.fir_causal(x, ht), lambda: HK.fir_causal_plain(x, ht), 5, 2,
        )
        work = HK.fir_causal.work(x, ht)
        gflop = work["flops"] / 1e9
        xpad, hflip = F.pad(x[:, None], (L - 1, 0)), ht.flip(0)[None, None].contiguous()
        with strict_fp32():
            yard = yardsticks(ms, work["flops"], FP32_FLOPS, work["bytes"],
                              "F.conv1d (cuDNN, TF32 off)", lambda: F.conv1d(xpad, hflip), 2)
        print(f"[kernel C] {label} ({rows}, {T}) x {L} taps: max_abs_err {abs_err:.3e} "
              f"rel {rel_err:.3e} (tol {KERNEL_RTOL:g}) | kernel {ms:.4f} ms "
              f"({gflop / ms:.2f} TFLOP/s) | plain {plain_ms:.4f} ms "
              f"({gflop / plain_ms:.2f} TFLOP/s) | bound {yard['bound_ms']:.4f} ms "
              f"({yard['bound_by']}, {yard['share_of_bound']:.1%}) | {yard['library']} "
              f"{yard['library_ms']:.4f} ms")
        expect(rel_err < KERNEL_RTOL, f"kernel C disagrees with its plain version ({label})")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)
    return results


def phase_kernel_d(dev):
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    ur, ui, cr, ci = rotation_main_case(dev)
    rows, n = ur.shape
    abs_err, _, ms, plain_ms = compare_kernel(
        "rotation_cumprod", lambda: HK.rotation_cumprod(ur, ui, cr, ci),
        lambda: HK.rotation_cumprod_plain(ur, ui, cr, ci), 10, 2,
    )
    gbytes = 4.0 * rows * n * 4 / 1e9
    # the library call: torch.cumprod of the complex rotations, built
    # outside the timed region; it is inclusive (no seed), D exclusive
    u = torch.complex(ur, ui)
    work = HK.rotation_cumprod.work(ur, ui, cr, ci)
    yard = yardsticks(ms, work["flops"], FP32_FLOPS, work["bytes"],
                      "torch.cumprod (complex64, inclusive)", lambda: torch.cumprod(u, dim=-1), 10)
    del u
    plan = HK.rotation_plan(rows, n)
    print(f"[kernel D] ({rows}, {n}) (plan {plan.rows_per_block} rows a block, {plan.stages} "
          f"stages of {plan.steps} steps, {16 if plan.wide else 4}-byte copies): max_abs_err "
          f"{abs_err:.3e} (must be 0) | kernel {ms:.4f} ms ({gbytes / ms:.2f} TB/s) | plain "
          f"{plain_ms:.4f} ms | bound {yard['bound_ms']:.4f} ms ({yard['bound_by']}, "
          f"{yard['share_of_bound']:.1%}) | {yard['library']} {yard['library_ms']:.4f} ms")
    expect(abs_err == 0.0, "kernel D differs from its plain version")
    return dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard), (ur, ui, cr, ci)


def phase_rotation(planes):
    """Kernel D's own path: no library path calls it, so it is driven
    through its public entry point, ``rotation_cumprod``, on the pitch
    shift's rows x steps of unit rotations. Launch counts are set to 0 just
    before and read just after."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    HK.reset_launch_counts()
    for _ in range(N_ITER + 1):
        pr, pi = HK.rotation_cumprod(*planes)
    torch.cuda.synchronize()
    launches = dict(HK.LAUNCHES)
    # products of unit rotations stay on the unit circle
    drift = float((torch.sqrt(pr * pr + pi * pi) - 1.0).abs().max())
    print(f"[entry rotation_cumprod] {tuple(pr.shape)}: |P| - 1 at most {drift:.3e} "
          f"(tol 1e-4) | kernel launches ({N_ITER + 1} calls): {launches}")
    expect(launches["rotation_cumprod"] > 0, f"rotation_cumprod: kernel D not launched: {launches}")
    expect(drift < 1e-4, "rotation_cumprod left the unit circle")
    return launches


# kernel F's chain bound: each of its n_blk - 1 steps is ns dependent FMAs,
# at the FMA's latency (4 cycles fp32, 8 fp64 on Hopper, microbenchmarked
# figures, an assumption here) and the H100 SXM's top SM clock
FMA_CYCLES = {4: 4, 8: 8}
SM_CLOCK_HZ = 1.98e9


def scan_main_case(dev, rows, dtype=torch.float32):
    """Kernel F's arguments at the exact meter's shapes: the K-weighting
    cascade's u and (A^L)^T for ``rows`` rows of 5 s (431 blocks of 512, 4
    states), from seeded noise."""
    from audiotools_tpu_torch.ops import filters as PFL
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    n = int(SR * DURATION)
    stages = [(b, a, g) for (b, a), g in PL.design_filters(SR)]
    key = tuple((tuple(map(float, b)), tuple(map(float, a)), float(g)) for b, a, g in stages)
    _, _, psi_x_t, a_l_t = PFL._iir_operators_on(key, 512, dev, dtype)
    x = torch.from_numpy(np.random.RandomState(rows).randn(rows, n) * 0.1).to(dev, dtype)
    with strict_fp32():
        return F.pad(x, (0, -n % 512)).reshape(rows, -1, 512) @ psi_x_t, a_l_t


@contextlib.contextmanager
def addmm_loop():
    """Every block-state recurrence through the loop of one ``addmm`` a
    block that kernel F replaced (its plain version), on the card too."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    kernel = HK.iir_block_scan
    HK.iir_block_scan = HK.iir_block_scan_plain
    try:
        yield
    finally:
        HK.iir_block_scan = kernel


def phase_kernel_f(dev):
    """Kernel F against its plain version (the addmm loop, also the
    yardstick: no single PyTorch call computes the recurrence) at the exact
    meter's shapes, beside its two bounds (bytes; the chain of dependent
    FMAs); then one exact meter call of 128 stacked rows through F and
    through the loop: host ms to enqueue it, device ms, and the device
    operations it launches (torch.profiler)."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops.ragged_shapes import SCAN_RTOL, SCAN_VS_PLAIN_ERROR

    results = {}
    # VolumeNorm's and the features' meter (64 rows), the mix's stacked
    # signal and noise (128), and the float64 biquads' type at 128
    for label, (rows, dtype) in {"meter": (BATCH, torch.float32),
                                 "meter_stacked": (2 * BATCH, torch.float32),
                                 "float64": (2 * BATCH, torch.float64)}.items():
        u, a_l_t = scan_main_case(dev, rows, dtype)
        _, n_blk, ns = u.shape
        kernel = lambda: HK.iir_block_scan(u, a_l_t)  # noqa: E731
        abs_err, rel_err, events_ms, plain_ms = compare_kernel(
            "iir_block_scan", kernel, lambda: HK.iir_block_scan_plain(u, a_l_t), 50, 3)
        if dtype == torch.float32:  # each against the float64 recurrence
            ref = HK.iir_block_scan_plain(u.cpu().double(), a_l_t.cpu().double())
            scale = ref.abs().max()
            err = {k: float((out.cpu().double() - ref).abs().max() / scale) for k, out in (
                ("kernel", kernel()), ("plain", HK.iir_block_scan_plain(u, a_l_t)))}
            accurate = err["kernel"] <= SCAN_VS_PLAIN_ERROR * err["plain"]
            against = (f"against the float64 recurrence: kernel {err['kernel']:.3e}, plain "
                       f"{err['plain']:.3e} (kernel within {SCAN_VS_PLAIN_ERROR:g}x)")
        else:
            accurate = rel_err < SCAN_RTOL[dtype]
            against = f"(tol {SCAN_RTOL[dtype]:g})"
        # the profiler's device time: F is shorter than its wrapper's host
        # time, so events around a loop of calls time the host
        _, busy_ms, count, _ = profile_step(lambda _: [kernel() for _ in range(50)], None)
        expect(count == 50, f"kernel F: the profiler saw {count} of 50 launches")
        ms = busy_ms / max(count, 1)
        work = HK.iir_block_scan.work(u, a_l_t)
        yard = yardsticks(ms, work["flops"], FP32_FLOPS if dtype == torch.float32 else FP32_FLOPS / 2,
                          work["bytes"], "none: no PyTorch call computes the block recurrence")
        chain_ms = (n_blk - 1) * ns * FMA_CYCLES[u.element_size()] / SM_CLOCK_HZ * 1e3
        plan = HK.scan_plan(rows, ns, u.element_size())
        print(f"[kernel F] {label} {tuple(u.shape)} {str(dtype)[6:]} (plan {plan.threads} rows a "
              f"block, {plan.blocks} blocks, inputs {plan.depth} steps ahead in a ring in shared "
              f"memory): kernel - plain max_abs_err {abs_err:.3e} rel {rel_err:.3e}; {against} | "
              f"kernel {ms * 1e3:.2f} us (profiler, mean of 50) | CUDA events over 50 calls "
              f"{events_ms * 1e3:.2f} us a call | plain (addmm "
              f"loop) {plain_ms:.4f} ms | bound {yard['bound_ms'] * 1e3:.3f} us ({yard['bound_by']}, "
              f"{yard['share_of_bound']:.1%}) | chain bound {chain_ms * 1e3:.2f} us "
              f"({chain_ms / ms:.1%})")
        expect(accurate, f"kernel F is less accurate than its plain version ({label})")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)

    x = torch.from_numpy(np.random.RandomState(11).randn(2 * BATCH, 1, int(SR * DURATION))
                         .astype(np.float32) * 0.1).to(dev)
    meter = {}
    for path, ctx in (("kernel F", contextlib.nullcontext), ("addmm loop", addmm_loop)):
        with ctx():
            before = HK.LAUNCHES["iir_block_scan"]
            PL.loudness(x, SR, use_fir=False)  # warm
            torch.cuda.synchronize()
            launched = HK.LAUNCHES["iir_block_scan"] - before
            host = []
            for _ in range(N_ITER):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                PL.loudness(x, SR, use_fir=False)
                host.append((time.perf_counter() - t0) * 1e3)
            device_ms = time_ms(lambda: PL.loudness(x, SR, use_fir=False), N_ITER)
            _, _, ops, _ = profile_step(lambda a: PL.loudness(a, SR, use_fir=False), x)
        meter[path] = dict(host_ms=float(np.median(host)), device_ms=device_ms, ops=ops,
                           f_launches=launched)
        print(f"[kernel F] exact meter call {tuple(x.shape)} through the {path}: host "
              f"{meter[path]['host_ms']:.3f} ms to enqueue (median of {N_ITER}) | device "
              f"{device_ms:.3f} ms | {ops} device operations (profiler) | kernel F launches "
              f"{launched}")
    expect(meter["kernel F"]["f_launches"] == 1 and meter["addmm loop"]["f_launches"] == 0,
           f"exact meter call: kernel F launches {meter}")
    return results, meter


# kernel G's shapes: the codec decoder's last Snake at 30 s (the largest a
# round trip runs), the training cell's first (18 x 64 x 16,896) and its
# deepest (18 x 1536 x 33 frames)
SNAKE_SHAPES = {"codec": (1, 96, 1_323_008), "training": (18, 64, 16_896),
                "training_deep": (18, 1536, 33)}


def snake_main_case(dev, shape, seed=12):
    """Kernel G's input at ``shape``: activations of 2 RMS, one positive
    alpha a channel around 1 (DAC initializes them at 1), a gradient."""
    rng = np.random.RandomState(seed)
    B, C, T = shape
    x = torch.from_numpy((rng.randn(B, C, T) * 2.0).astype(np.float32)).to(dev)
    alpha = torch.from_numpy(np.exp(rng.randn(1, C, 1) * 0.5).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(B, C, T).astype(np.float32)).to(dev)
    return x, alpha, g


def phase_kernel_g(dev):
    """Kernel G (DAC's Snake) at the codec's and the training cell's shapes.
    Forward: against the eager expression (its plain version, also the
    yardstick: eager is what the port ran), bit for bit. Backward: against
    autograd's backward of the expression, its forward excluded (x's
    gradient within a few ulp, alpha's relative to its largest value), and
    two runs bit-equal. Each timed by CUDA events beside its byte bound,
    and the device memory autograd keeps for one Snake under each."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    results = {}
    eps = torch.finfo(torch.float32).eps
    for label, shape in SNAKE_SHAPES.items():
        x, alpha, g = snake_main_case(dev, shape)
        abs_err, _, ms, plain_ms = compare_kernel(
            "snake", lambda: HK.snake(x, alpha), lambda: HK.snake_plain(x, alpha), 20, 5)
        expect(abs_err == 0.0, f"kernel G's forward is not the expression's bits ({label}: "
                               f"max_abs_err {abs_err:.3e})")
        work = HK.snake.work(x, alpha)
        yard = yardsticks(ms, work["flops"], FP32_FLOPS, work["bytes"],
                          "none: eager's five kernels are its plain version")

        xe, ae = x.clone().requires_grad_(True), alpha.clone().requires_grad_(True)
        ye = HK.snake_plain(xe, ae)
        want = torch.autograd.grad(ye, (xe, ae), g, retain_graph=True)
        got = HK.snake_backward(x, alpha, g)
        again = HK.snake_backward(x, alpha, g)
        torch.cuda.synchronize()
        size = g.abs() + (want[0] - g).abs()
        gx_abs = float((got[0] - want[0]).abs().max())
        gx_ulp = float(((got[0] - want[0]).abs() / (eps * size).clamp_min(1e-30)).max())
        ga_rel = float((got[1] - want[1]).abs().max() / want[1].abs().max())
        same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        expect(gx_ulp <= 4 and ga_rel < 1e-5 and same,
               f"kernel G's backward ({label}): gx {gx_ulp:.2f} ulp, g_alpha rel {ga_rel:.3e}, "
               f"repeatable {same}")
        eager_bwd = lambda: torch.autograd.grad(ye, (xe, ae), g, retain_graph=True)  # noqa: E731
        b_plain1 = time_ms(eager_bwd, 5)
        b_ms1 = time_ms(lambda: HK.snake_backward(x, alpha, g), 20)
        b_ms2 = time_ms(lambda: HK.snake_backward(x, alpha, g), 20)
        b_plain2 = time_ms(eager_bwd, 5)
        b_ms, b_plain = (b_ms1 + b_ms2) / 2, (b_plain1 + b_plain2) / 2
        b_work = HK.snake_backward.work(x, alpha, g)
        b_yard = yardsticks(b_ms, b_work["flops"], FP32_FLOPS, b_work["bytes"],
                            "none: autograd's backward of the eager chain is its yardstick")
        del ye, want, got, again

        saved = {}
        for path, fn in (("kernel G", HK.snake), ("eager", HK.snake_plain)):
            xs = x.clone().requires_grad_(True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            y = fn(xs, ae)
            torch.cuda.synchronize()
            saved[path] = torch.cuda.memory_allocated() - base - y.numel() * y.element_size()
            del y, xs
        print(f"[kernel G] {label} {tuple(x.shape)}: forward {ms:.4f} ms (CUDA events) | "
              f"eager chain {plain_ms:.4f} ms | bound {yard['bound_ms']:.4f} ms "
              f"({yard['bound_by']}, {yard['share_of_bound']:.1%}) | bit-equal "
              f"{abs_err == 0.0} || backward {b_ms:.4f} ms | eager autograd backward "
              f"{b_plain:.4f} ms | bound {b_yard['bound_ms']:.4f} ms ({b_yard['bound_by']}, "
              f"{b_yard['share_of_bound']:.1%}) | gx {gx_ulp:.2f} ulp, g_alpha rel "
              f"{ga_rel:.3e}, repeatable {same} || kept for backward: kernel G "
              f"{saved['kernel G'] / 2**20:.1f} MiB, eager {saved['eager'] / 2**20:.1f} MiB")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)
        results[f"{label} backward"] = dict(abs_err=gx_abs, ms=b_ms, plain_ms=b_plain,
                                            gx_ulp=gx_ulp, g_alpha_rel=ga_rel, saved=saved,
                                            **b_yard)
        del x, alpha, g, xe, ae
    return results


def peak_increment(fn):
    """Bytes that ``fn`` adds to the device's peak allocation."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def phase_kernel_e(dev):
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    rng = np.random.RandomState(5)
    out_len = int(SR * DURATION)
    results = {}
    # the chain's synthesis at +2 st (64 x 432 frames of 2048, hop 512), and
    # the same audio at n_fft 512, hop 128
    for label, (n_fft, hop, nt) in {
        "chain": (2048, 512, 432),
        "n_fft512": (512, 128, 1 + 4 * 432),
    }.items():
        n_freq = n_fft // 2 + 1
        shape = (BATCH, nt, n_freq)
        spec = torch.from_numpy(
            ((rng.randn(*shape) + 1j * rng.randn(*shape)) * 0.05).astype(np.complex64)).to(dev)
        (w,) = PF._on_device(PF._synthesis_design, ("hann", n_fft, hop), dev)
        (env,) = PF._on_device(PF._inverse_envelope, ("hann", n_fft, hop, nt), dev)
        abs_err, rel_err, ms, plain_ms = compare_kernel(
            "istft_synthesis_fused", lambda: HK.istft_synthesis_fused(spec, w, hop, env),
            lambda: HK.istft_synthesis_fused_plain(spec, w, hop, env), 10, 3,
        )
        work = HK.istft_synthesis_fused.work(spec, w, hop, env)
        gflop = work["flops"] / 1e9
        # the library call: torch.istft of the same spectrum (frequency-major,
        # copied outside the timed region), Hann window, hop, the same
        # samples after the center trim, fp32 (cuFFT)
        spec_fm = spec.transpose(1, 2).contiguous()
        window = torch.hann_window(n_fft, device=dev)
        yard = yardsticks(ms, work["flops"], BF16_FLOPS, work["bytes"], "torch.istft (fp32, cuFFT)",
                          lambda: torch.istft(spec_fm, n_fft, hop, window=window, center=True,
                                              length=hop * (nt - 1)), 10)
        del spec_fm
        print(f"[kernel E] {label} {shape} x ({n_fft}, hop {hop}): max_abs_err {abs_err:.3e} "
              f"rel {rel_err:.3e} (tol {KERNEL_RTOL:g}) | kernel {ms:.4f} ms "
              f"({gflop / ms:.2f} TFLOP/s) | plain {plain_ms:.4f} ms | bound "
              f"{yard['bound_ms']:.4f} ms ({yard['bound_by']}, {yard['share_of_bound']:.1%}) | "
              f"{yard['library']} {yard['library_ms']:.4f} ms")
        expect(rel_err < KERNEL_RTOL, f"kernel E disagrees with its plain version ({label})")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)

    # peak memory at the chain's shape (432 synthesis frames): E against the
    # unfused bf16 iSTFT, on a spectrum laid out as kernel B writes it
    # (time-major, read in place); and with match_stride, whose two zero
    # frames at each end E reads as zeros instead of padding a copy
    frames = BATCH * 432 * 2048 * 4
    peaks = {}
    for match_stride in (False, True):
        nt = 432 - 4 * match_stride
        shape = (BATCH, 1, nt, 1025)
        stft_data = torch.from_numpy(
            ((rng.randn(*shape) + 1j * rng.randn(*shape)) * 0.05).astype(np.complex64)
        ).to(dev).transpose(-1, -2)
        kw = dict(match_stride=True, original_length=nt * 512) if match_stride else dict(
            length=out_len)
        for m in ("matmul_bf16_fused", "matmul_bf16"):
            PF.istft(stft_data, 2048, 512, method=m, **kw)  # warm-up: the cached designs
            peaks[m, match_stride] = peak_increment(
                lambda: PF.istft(stft_data, 2048, 512, method=m, **kw))
        print(f"[kernel E] peak-memory increment at {shape}, match_stride {match_stride}: "
              f"fused {peaks['matmul_bf16_fused', match_stride] / 1e6:.1f} MB, matmul_bf16 "
              f"{peaks['matmul_bf16', match_stride] / 1e6:.1f} MB (frame tensor "
              f"{frames / 1e6:.1f} MB)")
        expect(peaks["matmul_bf16_fused", match_stride] < frames,
               f"kernel E's peak-memory increment (match_stride {match_stride}) is not below "
               f"the frame tensor it never builds")
        expect(peaks["matmul_bf16_fused", match_stride] <= E_PEAK_LIMIT,
               f"kernel E's peak-memory increment (match_stride {match_stride}) is above "
               f"{E_PEAK_LIMIT / 1e6:g} MB")
    return results, peaks


def phase_ragged(dev):
    """Every kernel against its plain version at the shapes of
    ``ops.ragged_shapes``, which do not fill their tiles: A, C, E and F
    (both types) within the relative tolerance, B (both variants) and D bit
    for bit."""
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import ragged_shapes as RAGGED

    rng = np.random.RandomState(6)
    worst = {}
    for kind, rows, T, L in ([("A", *s) for s in RAGGED.FIR_BATCH]
                             + [("C", *s) for s in RAGGED.FIR_SHARED]):
        x = torch.from_numpy(rng.randn(rows, T).astype(np.float32)).to(dev)
        if kind == "A":
            h = torch.from_numpy((rng.randn(rows, L) * 0.05).astype(np.float32)).to(dev)
            got, want = HK.fir_causal_batch(x, h), HK.fir_causal_batch_plain(x, h)
        else:
            h = torch.from_numpy((rng.randn(L) * 0.05).astype(np.float32)).to(dev)
            got, want = HK.fir_causal(x, h), HK.fir_causal_plain(x, h)
        err = float((got - want).abs().max() / want.abs().max())
        worst[kind] = max(worst.get(kind, 0.0), err)
    for B, nt, n_fft, hop in RAGGED.SYNTHESIS:
        n_freq = n_fft // 2 + 1
        spec = torch.from_numpy(((rng.randn(B, nt, n_freq) + 1j * rng.randn(B, nt, n_freq)) * 0.1)
                                .astype(np.complex64)).to(dev)
        (w,) = PF._on_device(PF._synthesis_design, ("hann", n_fft, hop), dev)
        for edge in (0, 2):
            (env,) = PF._on_device(PF._inverse_envelope, ("hann", n_fft, hop, nt + 2 * edge), dev)
            got = HK.istft_synthesis_fused(spec, w, hop, env, edge)
            want = HK.istft_synthesis_fused_plain(spec, w, hop, env, edge)
            err = float((got - want).abs().max() / want.abs().max())
            worst["E"] = max(worst.get("E", 0.0), err)
    for rows, n_blk, ns in RAGGED.IIR_SCAN:
        q, _ = np.linalg.qr(rng.randn(ns, ns))
        for dtype, key in ((torch.float32, "F"), (torch.float64, "F float64")):
            a_l_t = torch.from_numpy(q * 0.9).to(dev, dtype)  # a contracting transition
            u = torch.from_numpy(rng.randn(rows, n_blk, ns)).to(dev, dtype)
            got, want = HK.iir_block_scan(u, a_l_t), HK.iir_block_scan_plain(u, a_l_t)
            err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
            worst[key] = max(worst.get(key, 0.0), err)
    exact = {}  # B and D: max abs error, which must be 0
    for case, (shape, rate) in enumerate(RAGGED.PV):
        z, i0, i1, frac = RAGGED.pv_case(shape, rate, seed=case)
        z = torch.from_numpy(z).to(dev)
        for with_phasor in (False, True):
            got = HK.phase_vocoder_fused(z, i0, i1, frac, with_phasor=with_phasor)
            want = HK.phase_vocoder_fused_plain(z, i0, i1, frac, with_phasor=with_phasor)
            got, want = (got, want) if with_phasor else ((got,), (want,))
            key = "B with phasor" if with_phasor else "B"
            exact[key] = max([exact.get(key, 0.0)] + [float((g - w).abs().max())
                                                      for g, w in zip(got, want)])
    for shape in RAGGED.ROTATION:
        ang = rng.uniform(-np.pi, np.pi, shape)
        seed = rng.uniform(-np.pi, np.pi, shape[:-1])
        planes = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (
            np.cos(ang), np.sin(ang), np.cos(seed), np.sin(seed))]
        got, want = HK.rotation_cumprod(*planes), HK.rotation_cumprod_plain(*planes)
        exact["D"] = max([exact.get("D", 0.0)] + [float((g - w).abs().max())
                                                  for g, w in zip(got, want)])
    torch.cuda.synchronize()
    print("[ragged] worst rel. err against the plain versions: " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()) + f" (tol {KERNEL_RTOL:g}); max abs err: "
        + ", ".join(f"{k} {v:.3e}" for k, v in exact.items())
        + f" (must be 0; {len(RAGGED.PV)} B and {len(RAGGED.ROTATION)} D shapes)")
    for k, v in worst.items():
        expect(v < KERNEL_RTOL, f"kernel {k} disagrees with its plain version at a ragged shape")
    for k, v in exact.items():
        expect(v == 0.0, f"kernel {k} differs from its plain version at a ragged shape")


def make_dataset(root, n_examples, use_original_phase=False):
    """The main path's AudioDataset; ``use_original_phase``: the reverb keeps
    the dry signal's STFT phase (``RoomImpulseResponse``'s flag)."""
    from audiotools_tpu_torch.data import transforms as tfm
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader

    transform = tfm.Compose(
        tfm.RoomImpulseResponse(sources=[str(root / "ir.csv")],
                                use_original_phase=use_original_phase),
        tfm.BackgroundNoise(sources=[str(root / "nz.csv")]),
        tfm.Equalizer(),
        tfm.VolumeNorm(),
    )
    return AudioDataset(AudioLoader(sources=[str(root / "spk.csv")]), sample_rate=SR,
                        n_examples=n_examples, duration=DURATION, transform=transform)


def make_zoo_dataset(root, n_examples):
    """AudioDataset over the speech fixtures with every leaf transform."""
    from audiotools_tpu_torch.data import transforms as tfm
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader

    transform = tfm.Compose(
        tfm.RoomImpulseResponse(sources=[str(root / "ir.csv")]),
        tfm.BackgroundNoise(sources=[str(root / "nz.csv")]),
        tfm.CrossTalk(sources=[str(root / "spk.csv")]),
        tfm.NoiseFloor(), tfm.Choose(tfm.LowPass(), tfm.HighPass()), tfm.Equalizer(),
        tfm.ClippingDistortion(prob=0.5),
        tfm.Choose(tfm.Quantization(), tfm.MuLawQuantization(), prob=0.5),
        tfm.Smoothing(prob=0.5), tfm.RepeatUpTo(tfm.VolumeChange(), max_repeat=3),
        tfm.SpectralDenoising(prob=0.5),
        tfm.Choose(tfm.ShiftPhase(), tfm.InvertPhase(), tfm.CorruptPhase()),
        tfm.FrequencyMask(prob=0.5), tfm.TimeMask(prob=0.5), tfm.MaskLowMagnitudes(prob=0.5),
        tfm.FrequencyNoise(prob=0.5), tfm.TimeNoise(prob=0.5), tfm.Silence(),
        tfm.GlobalVolumeNorm(), tfm.VolumeNorm(), tfm.RescaleAudio(),
    )
    return AudioDataset(AudioLoader(sources=[str(root / "spk.csv")]), sample_rate=SR,
                        n_examples=n_examples, duration=DURATION, transform=transform)


def _holds(tfm, kinds):
    """Whether a transform of the zoo is, or holds, one of ``kinds``."""
    return isinstance(tfm, kinds) or any(_holds(c, kinds) for c in getattr(tfm, "transforms", []))


def _one_sided_empty_samples(signal, dev):
    """``(B, C, T)`` bool: the samples inside a frame whose STFT (at the
    signal's parameters) holds a cell that the noise fills read as empty
    (magnitude and phase 0, i.e. exactly zero) on one device and not on the
    other."""
    def empty(s):
        s.stft()
        return ((s.magnitude == 0) & (s.phase == 0)).cpu()

    p = signal.stft_params
    one_sided = (empty(signal.clone()) != empty(signal.clone().to(dev))).any(dim=-2)
    out = torch.zeros(signal.audio_data.shape, dtype=torch.bool)
    for b, c, t in one_sided.nonzero().tolist():
        start = t * p.hop_length - p.window_length // 2
        out[b, c, max(start, 0):max(start + p.window_length, 0)] = True
    return out


def _zoo_children(ds, batch, marks):
    """The zoo chain child by child, as ``Compose`` runs it, appending a
    CUDA event to ``marks`` before the first and after each."""
    def mark():
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    signal = batch["signal"].clone()
    kwargs = batch["transform_args"]["Compose"]
    mark()
    for tfm in ds.transform:
        signal = tfm(signal, **kwargs)
        mark()
    return signal


def phase_zoo(root, dev, card):
    """The zoo chain on a staged batch of 64 x 5 s: the first run through
    ``Compose.transform``, then timed child by child. Launch counts are set
    to 0 just before the first run and read just after the last."""
    from audiotools_tpu_torch.core import util
    from audiotools_tpu_torch.data import DataLoader
    from audiotools_tpu_torch.data import transforms as tfms
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    ds = make_zoo_dataset(root, BATCH)
    t0 = time.perf_counter()
    batch = next(iter(DataLoader(ds, batch_size=BATCH, num_workers=8)))  # to the card by default
    torch.cuda.synchronize()
    print(f"[zoo] first batch through DataLoader (8 workers, staged to the card): "
          f"{time.perf_counter() - t0:.2f} s")
    args = batch["transform_args"]["Compose"]
    names = [t.name for t in ds.transform]
    applied = {n: int(np.asarray(args[n]["mask"]).sum()) for n in names}
    print(f"[zoo] items each transform applies to (of {BATCH}): {applied}")
    expect(batch["signal"].device.type == "cuda", f"zoo batch on {batch['signal'].device}")
    expect(any(0 < v < BATCH for v in applied.values()), "no transform mixes its mask")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    HK.reset_launch_counts()
    t0 = time.perf_counter()
    out = ds.transform(batch["signal"].clone(), **batch["transform_args"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    stages = np.zeros(len(names))
    t0 = time.perf_counter()
    for _ in range(ZOO_RUNS - 1):
        marks = []
        out = _zoo_children(ds, batch, marks)
        torch.cuda.synchronize()
        stages += [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    wall_ms = (time.perf_counter() - t0) * 1000 / (ZOO_RUNS - 1)
    launches = dict(HK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    stages /= ZOO_RUNS - 1
    ms = float(stages.sum())
    print(f"[zoo] {len(names)} transforms, {BATCH} x {DURATION:g} s @ {SR} Hz: {ms:.3f} ms/batch "
          f"(CUDA events, mean of {ZOO_RUNS - 1} runs after one untimed of {first_s:.2f} s; host "
          f"wall {wall_ms:.3f} ms) | {BATCH / ms * 1000:.1f} clips/s | peak {peak / 2**30:.3f} "
          f"GiB | {card}")
    print("[zoo] per transform (ms): " + ", ".join(f"{n} {t:.3f}" for n, t in zip(names, stages)))
    print(f"[zoo] kernel launches ({ZOO_RUNS} runs): {launches}")
    expect(launches["fir_causal_batch"] > 0, f"zoo: kernel A was not launched: {launches}")
    expect(tuple(out.audio_data.shape) == (BATCH, 1, int(SR * DURATION)),
           f"zoo output shape {tuple(out.audio_data.shape)}")
    expect(bool(torch.isfinite(out.audio_data).all()), "zoo: non-finite output")
    expect(float(out.audio_data.abs().max()) <= 1.0 + 1e-6, "zoo: RescaleAudio left a peak above 1")
    del out, batch

    items = util.collate([ds[i] for i in range(N_CHECK)])
    on_card, on_cpu = util.prepare_batch(items, dev), util.prepare_batch(items, "cpu")
    signal = on_cpu["signal"].clone()
    errors = {}
    quantizers = (tfms.Quantization, tfms.MuLawQuantization)
    for tfm in ds.transform:
        kept = torch.ones(signal.audio_data.shape, dtype=torch.bool)
        if _holds(tfm, (tfms.TimeNoise, tfms.FrequencyNoise)):
            kept = ~_one_sided_empty_samples(signal, dev)
        got = tfm(signal.clone().to(dev), **on_card["transform_args"]["Compose"])
        signal = tfm(signal, **on_cpu["transform_args"]["Compose"])
        diff = (got.audio_data.cpu() - signal.audio_data).abs()
        err, share = float(diff[kept].max()), float((diff > ZOO_ABS).float().mean())
        errors[tfm.name] = (err, share, 1 - float(kept.float().mean()))
        if _holds(tfm, quantizers):
            expect(share <= ZOO_SHARE, f"zoo card vs CPU {tfm.name}: share {share:.3e} > {ZOO_SHARE:g}")
        else:
            expect(err <= ZOO_ABS, f"zoo card vs CPU {tfm.name}: {err:.3e} > {ZOO_ABS:g}")
    print(f"[zoo card vs cpu] {N_CHECK} clips, each transform on the same input: max abs err "
          f"(tol {ZOO_ABS:g}) / share of samples over it (quantizers, tol {ZOO_SHARE:g}) / share "
          f"left out (frames holding a cell exactly zero on one device only; noise fills only): "
          + ", ".join(
              f"{n} {e:.3e}/{s:.2e}/{x:.2e}" for n, (e, s, x) in errors.items()))
    expect(bool(torch.isfinite(signal.audio_data).all()), "zoo on the CPU: non-finite output")
    return launches, dict(ms=ms, stages=dict(zip(names, stages.tolist())), peak=peak,
                          errors=errors)


def make_multitrack_dataset(root, n_examples):
    """Two voices of the chord fixture as one aligned AudioDataset."""
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader

    loaders = {v: AudioLoader(sources=[str(root / f"{v}.csv")]) for v in MT_VOICES}
    return AudioDataset(loaders, sample_rate=SR, n_examples=n_examples, duration=DURATION,
                        aligned=True)


def _mix_voices(batch):
    """The voices of a batch staged with the int16 wire, dequantized and summed."""
    mix = None
    for voice in MT_VOICES:
        signal = batch[voice]["signal"].clone().dequantize_wire()
        mix = signal if mix is None else mix + signal
    return mix


def multitrack_path(batch, curve, out_dir, stage=lambda name: None):
    """The multitrack path on a batch staged with the int16 wire: the voices
    dequantized and summed; then at each factor the stretch (kernel B), the
    EQ (kernel A), and from the EQ'd audio the band split, the K-weighting
    cascade, the MFCCs, the window round trip and two items written (float
    WAV) and read back. ``stage(name)`` is called after each stage."""
    from audiotools_tpu_torch.io import read_wav
    from audiotools_tpu_torch.ops import filters as PFL

    mix = _mix_voices(batch)
    stage("mix")
    out = {}
    for factor in MT_FACTORS:
        signal = mix.clone().time_stretch(factor, pv_formulation="phasor_fused")
        stretched = signal.audio_data
        stage(f"time_stretch {factor:g}")
        signal.equalizer(curve, conv_method="pallas")
        stage(f"equalizer {factor:g}")
        bands = signal.mel_filterbank(MT_BANDS)
        stage(f"split_bands {factor:g}")
        weighted = PFL.biquad_cascade(signal.audio_data, _k_weighting())
        stage(f"biquad_cascade {factor:g}")
        mfcc = signal.mfcc(*MT_MFCC)
        stage(f"mfcc {factor:g}")
        windows = signal.clone().collect_windows(*MT_WINDOW).overlap_and_add(MT_WINDOW[1])
        stage(f"windows {factor:g}")
        read = []
        for i in range(2):
            path = Path(out_dir) / f"multitrack_{factor:g}_{i}.wav"
            signal[i].write(path, subtype="FLOAT")
            read.append(read_wav(path)[0])
        stage(f"save_read {factor:g}")
        out[factor] = dict(stretched=stretched, eq=signal.audio_data, bands=bands,
                           weighted=weighted, mfcc=mfcc, windows=windows.audio_data,
                           read=np.stack(read))
    return mix.audio_data, out


def _k_weighting():
    from audiotools_tpu_torch.ops import loudness as PL

    return [(b, a, g) for (b, a), g in PL.design_filters(SR, "K-weighting")]


def _multitrack_checks(mix, out):
    """Shapes, finite values, the bands' partition of unity, the exact window
    round trip and read-back of the path's run; returns the partition's
    largest error and the EQ'd audio's peak."""
    n = mix.shape[0]
    worst_sum, peak = 0.0, 0.0
    for factor, o in out.items():
        tag = f"multitrack {factor:g}"
        length = int(round(int(SR * DURATION) / factor))
        eq = o["eq"]
        expect(tuple(eq.shape) == (n, 1, length), f"{tag}: EQ shape {tuple(eq.shape)}")
        expect(tuple(o["bands"].shape) == (n, 1, length, MT_BANDS),
               f"{tag}: bands shape {tuple(o['bands'].shape)}")
        expect(tuple(o["mfcc"].shape) == (n, 1, MT_MFCC[0], 1 + length // 512),
               f"{tag}: mfcc shape {tuple(o['mfcc'].shape)}")
        for name in ("stretched", "eq", "bands", "weighted", "mfcc", "windows"):
            expect(bool(torch.isfinite(o[name]).all()), f"{tag}: non-finite {name}")
        err = float((o["bands"].sum(-1) - eq).abs().max())
        worst_sum, peak = max(worst_sum, err), max(peak, float(eq.abs().max()))
        expect(err <= MT_TOL["bands_sum_abs"], f"{tag}: bands sum to their input within {err:.3e}")
        expect(torch.equal(o["windows"], eq), f"{tag}: window round trip is not exact")
        expect(np.array_equal(o["read"], eq[:2].cpu().numpy()),
               f"{tag}: a written item did not read back as written")
    return worst_sum, peak


def phase_multitrack(root, dev, card):
    """The multitrack path on the card: fixture, loader, 1 untimed and
    N_ITER timed runs with CUDA events between the stages (plus one run
    reading each stage's peak memory), kernels B and A against their plain
    versions at the path's shapes, and the path card vs CPU. Launch counts
    are set to 0 just before the untimed run and read just after the last
    timed one."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.core import util
    from audiotools_tpu_torch.data import DataLoader
    from audiotools_tpu_torch.data.datasets import ResumableSequentialSampler
    from audiotools_tpu_torch.data.loader import _wire_quantize
    from audiotools_tpu_torch.io import read_wav
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import filters as PFL
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import stretch as PS
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    chords = root / "chords"
    t0 = time.perf_counter()
    util.seed(0)
    util.generate_chord_dataset(max_voices=4, num_items=BATCH, duration=DURATION,
                                sample_rate=SR, output_dir=chords)
    fixture_s = time.perf_counter() - t0
    ds = make_multitrack_dataset(chords, BATCH)
    silent = sum(e["path"] == "none" for e in ds.loaders[MT_VOICES[1]].audio_lists[0])
    loader = DataLoader(ds, batch_size=BATCH, sampler=ResumableSequentialSampler(ds),
                        drop_last=True, num_workers=8, wire_dtype="int16")
    t0 = time.perf_counter()
    batch = next(iter(loader))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    wire = {v: (str(batch[v]["signal"].audio_data.dtype), batch[v]["signal"].device.type)
            for v in MT_VOICES}
    print(f"[multitrack] chord fixture ({BATCH} tracks, {silent} without {MT_VOICES[1]}): "
          f"{fixture_s:.2f} s | first batch through DataLoader (8 workers, int16 wire, staged "
          f"to the card): {first_s:.2f} s | wire {wire}")
    expect(all(w == ("torch.int16", "cuda") for w in wire.values()), f"multitrack wire {wire}")
    expect(len(loader) == 1 and batch["idx"].tolist() == list(range(BATCH)),
           "multitrack: the sampler's batch is not items 0..63")
    # as the Equalizer transform draws it (eq_amount 1): log10 gains in [-1, 0]
    curve = torch.from_numpy(-np.random.RandomState(7).rand(BATCH, MT_BANDS)
                             .astype(np.float32)).to(dev)

    with tempfile.TemporaryDirectory(dir=root) as out_dir:
        HK.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        peaks = {}

        def read_peak(name):
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

        multitrack_path(batch, curve, out_dir, read_peak)  # untimed, each stage's peak
        names, stages = list(peaks), np.zeros(len(peaks))
        t0 = time.perf_counter()
        for _ in range(N_ITER):
            marks = [torch.cuda.Event(enable_timing=True)]
            marks[0].record()

            def mark(name):
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()

            mix, out = multitrack_path(batch, curve, out_dir, mark)
            torch.cuda.synchronize()
            stages += [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        wall_ms = (time.perf_counter() - t0) * 1000 / N_ITER
        launches = dict(HK.LAUNCHES)
    stages /= N_ITER
    ms = float(stages.sum())
    print(f"[multitrack] {BATCH} x {DURATION:g} s @ {SR} Hz, factors {MT_FACTORS}: {ms:.3f} "
          f"ms/batch (CUDA events, mean of {N_ITER} runs after one untimed; host wall "
          f"{wall_ms:.3f} ms) | peak {max(peaks.values()) / 2**30:.3f} GiB | {card}")
    print("[multitrack] stages (ms / peak GiB): " + ", ".join(
        f"{n} {t:.3f} / {peaks[n] / 2**30:.3f}" for n, t in zip(names, stages)))
    print(f"[multitrack] kernel launches ({N_ITER + 1} runs): {launches}")
    for name in ("fir_causal_batch", "phase_vocoder_fused"):
        expect(launches[name] >= (N_ITER + 1) * len(MT_FACTORS),
               f"multitrack: kernel {name} was not launched at every factor: {launches}")
    sum_card = _multitrack_checks(mix, out)

    # kernel B at the two stretch shapes, on the path's own spectrum
    z = PF.stft(mix.reshape(-1, mix.shape[-1]), 2048, 512, "hann", method="matmul")[:, None]
    kernels = {"B": {}, "A": {}}
    for factor in MT_FACTORS:
        i0, i1, frac = PS._pv_indices(z.shape[-1], factor)
        abs_err, _, k_ms, plain_ms = compare_kernel(
            "phase_vocoder_fused", lambda: HK.phase_vocoder_fused(z, i0, i1, frac),
            lambda: HK.phase_vocoder_fused_plain(z, i0, i1, frac), 10, 2)
        n = len(i0)
        work = HK.phase_vocoder_fused.work(z, i0, i1, frac)
        yard = yardsticks(k_ms, work["flops"], FP32_FLOPS, work["bytes"])
        print(f"[multitrack kernel B] {tuple(z.shape)} -> {n} steps (factor {factor:g}): "
              f"max_abs_err {abs_err:.3e} (must be 0) | kernel {k_ms:.4f} ms | plain "
              f"{plain_ms:.4f} ms | bound {yard['bound_ms']:.4f} ms ({yard['bound_by']}, "
              f"{yard['share_of_bound']:.1%})")
        expect(abs_err == 0.0, f"kernel B differs from its plain version at factor {factor:g}")
        kernels["B"][factor] = dict(abs_err=abs_err, ms=k_ms, plain_ms=plain_ms, **yard)

    # kernel A: the path's EQ through the kernel and through its plain
    # version, on the path's stretched audio; then timed at that shape
    rng = np.random.RandomState(8)
    for factor in MT_FACTORS:
        stretched = out[factor]["stretched"]
        eq = {m: AudioSignal(stretched, SR).equalizer(curve, conv_method=m).audio_data
              for m in ("pallas", "pallas_interpret")}
        rel = float((eq["pallas"] - eq["pallas_interpret"]).abs().max()
                    / eq["pallas_interpret"].abs().max())
        rows_a, T_a, L = BATCH, stretched.shape[-1] + 640, 641
        x = torch.from_numpy(rng.randn(rows_a, T_a).astype(np.float32)).to(dev)
        h = torch.from_numpy((rng.randn(rows_a, L) * 0.05).astype(np.float32)).to(dev)
        abs_err, rel_err, k_ms, plain_ms = compare_kernel(
            "fir_causal_batch", lambda: HK.fir_causal_batch(x, h),
            lambda: HK.fir_causal_batch_plain(x, h), 10, 3)
        xpad, hflip = F.pad(x, (L - 1, 0))[None], h.flip(-1)[:, None, :].contiguous()
        with strict_fp32():
            work = HK.fir_causal_batch.work(x, h)
            yard = yardsticks(k_ms, work["flops"], FP32_FLOPS, work["bytes"],
                              "F.conv1d (cuDNN, TF32 off)",
                              lambda: F.conv1d(xpad, hflip, groups=rows_a))
        del xpad, hflip
        print(f"[multitrack kernel A] ({rows_a}, {T_a}) x {L} taps (factor {factor:g}): the "
              f"path's EQ through A vs its plain version rel {rel:.3e}; random inputs rel "
              f"{rel_err:.3e} (tol {KERNEL_RTOL:g}) | kernel {k_ms:.4f} ms | plain {plain_ms:.4f} "
              f"ms | bound {yard['bound_ms']:.4f} ms ({yard['bound_by']}, "
              f"{yard['share_of_bound']:.1%}) | {yard['library']} {yard['library_ms']:.4f} ms")
        expect(rel < KERNEL_RTOL and rel_err < KERNEL_RTOL,
               f"kernel A disagrees with its plain version at factor {factor:g}")
        kernels["A"][factor] = dict(abs_err=abs_err, ms=k_ms, plain_ms=plain_ms, path_rel=rel,
                                    **yard)
    del z, mix, out, batch

    # the path on the card and on the CPU (plain versions) for N_CHECK clips,
    # stage by stage: each stage on both devices from the CPU's output of the
    # stage before, the stretch and the MFCCs in their parts (see MT_TOL)
    errors = {}
    items = _wire_quantize(util.collate([ds[i] for i in range(N_CHECK)]), "int16")
    mix = {d: _mix_voices(util.prepare_batch(items, d)).audio_data for d in (dev, "cpu")}
    x, check_curve = mix["cpu"], curve[:N_CHECK].cpu()
    devices = (dev, "cpu")

    def held(got, want, rel=False):
        err = float((got.cpu() - want).abs().max())
        return err / float(want.abs().max()) if rel else err

    with tempfile.TemporaryDirectory(dir=root) as out_dir:
        for factor in MT_FACTORS:
            e = errors[factor] = {"mix_abs": held(mix[dev], x)}
            whole = {d: AudioSignal(x.to(d), SR).time_stretch(
                factor, pv_formulation="phasor_fused").audio_data for d in devices}
            spec = {d: PF.stft(x.to(d), 2048, 512, "hann", method="matmul") for d in devices}
            e["stft_rel"] = held(spec[dev], spec["cpu"], rel=True)
            voc = {d: PS.phase_vocoder(spec["cpu"].to(d), factor, 512, 2048, "phasor_fused")
                   for d in devices}
            e["vocoder_abs"] = held(voc[dev], voc["cpu"])
            length = int(round(x.shape[-1] / factor))
            st = {d: PF.istft(voc["cpu"].to(d), 2048, 512, "hann", length=length,
                              method="matmul") for d in devices}
            e["istft_abs"] = held(st[dev], st["cpu"])
            eq = {d: AudioSignal(st["cpu"].to(d), SR).equalizer(
                check_curve.to(d), conv_method="pallas").audio_data for d in devices}
            e["eq_abs"] = held(eq[dev], eq["cpu"])
            src = {d: AudioSignal(eq["cpu"].to(d), SR) for d in devices}
            bands = {d: src[d].mel_filterbank(MT_BANDS) for d in devices}
            e["bands_abs"] = held(bands[dev], bands["cpu"])
            e["bands_sum_abs"] = max(held(bands[d].sum(-1), eq["cpu"]) for d in devices)
            weighted = {d: PFL.biquad_cascade(src[d].audio_data, _k_weighting()) for d in devices}
            e["weighted_abs"] = held(weighted[dev], weighted["cpu"])
            windows = {d: src[d].clone().collect_windows(*MT_WINDOW).overlap_and_add(
                MT_WINDOW[1]).audio_data for d in devices}
            e["windows_abs"] = held(windows[dev], windows["cpu"])
            mel = {d: src[d].mel_spectrogram(MT_MFCC[1]) for d in devices}
            e["mel_rel"] = held(mel[dev], mel["cpu"], rel=True)
            with strict_fp32():
                log_dct = {d: AudioSignal.get_dct(*MT_MFCC, device=d).T
                           @ torch.log(mel["cpu"].to(d) + 1e-6) for d in devices}
            e["log_dct_rel"] = held(log_dct[dev], log_dct["cpu"], rel=True)
            mfcc = {d: src[d].mfcc(*MT_MFCC) for d in devices}
            expect(torch.equal(mfcc["cpu"], log_dct["cpu"]), "mfcc is not the log-DCT of the mel")
            for d in devices:
                path = Path(out_dir) / f"check_{factor:g}_{torch.device(d).type}.wav"
                src[d][0].write(path, subtype="FLOAT")
                expect(np.array_equal(read_wav(path)[0], eq["cpu"][0].numpy()),
                       f"multitrack ({factor:g}, {d}): a written item did not read back")
            for k, v in e.items():
                expect(v <= MT_TOL[k],
                       f"multitrack card vs CPU ({factor:g}) {k} {v:.3e} > {MT_TOL[k]:g}")
            # the composites, not held (MT_TOL)
            e["time_stretch_whole_abs"] = held(whole[dev], whole["cpu"])
            e["mfcc_whole_rel"] = held(mfcc[dev], mfcc["cpu"], rel=True)
    print(f"[multitrack card vs cpu] {N_CHECK} clips, each stage from the CPU's input: " + "; ".join(
        f"factor {f:g}: " + ", ".join(f"{k} {v:.3e}" + (f" (tol {MT_TOL[k]:g})" if k in MT_TOL
                                                          else " (not held)")
                                     for k, v in e.items()) for f, e in errors.items())
        + f" | bands' sum vs input on the whole batch (input peak): {sum_card[0]:.3e} "
        f"({sum_card[1]:.3f})")
    return launches, dict(ms=ms, stages=dict(zip(names, stages.tolist())), peaks=peaks,
                          first_s=first_s, errors=errors, kernels=kernels)


def run_chain(ds, batch, synthesis_method="matmul_bf16", marks=None):
    """The main path on a staged batch; ``marks`` collects a CUDA event
    after each stage (chain, pitch shift, mel, loudness). The meter is the
    process-wide default (``loudness.set_fast_meter``)."""
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops import stretch as PS

    def mark():
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

    mark()
    out = ds.transform(batch["signal"].clone(), **batch["transform_args"])
    mark()
    audio = PS.pitch_shift(out.audio_data, 2.0, SR, synthesis_method=synthesis_method,
                           pv_formulation="phasor_fused")
    mark()
    mel = PF.mel_spectrogram(audio, SR, 80, method="matmul")
    mark()
    lufs = PL.loudness(audio, SR)
    mark()
    return audio, mel, lufs


@contextlib.contextmanager
def meter(fast: bool):
    """The process-wide meter for one path; the exact meter is restored
    on the way out, whatever happens inside."""
    from audiotools_tpu_torch.ops import loudness as PL

    PL.set_fast_meter(fast)
    try:
        yield
    finally:
        PL.set_fast_meter(False)


# (label, the reverb's use_original_phase, fast meter, synthesis method,
# kernels the path must launch)
PATHS = [
    ("main", False, False, "matmul_bf16",
     ("fir_causal_batch", "phase_vocoder_fused", "iir_block_scan")),
    ("parity", False, True, "matmul_bf16_fused",
     ("fir_causal_batch", "phase_vocoder_fused", "fir_causal", "istft_synthesis_fused")),
    ("original_phase", True, False, "matmul_bf16",
     ("fir_causal_batch", "phase_vocoder_fused", "iir_block_scan")),
]
# the silence-led copies of the card-vs-CPU check: their first 0.25 s set
# to exact zeros (digital silence, where the sign of the FFT's zeros decided
# the dry phase before it read 0 at every exactly-zero cell)
SILENT_LEAD_S = 0.25


def stage_batch(root, use_original_phase):
    """The main path's dataset (with the reverb's flag) and its first batch
    through ``DataLoader``, staged to the card."""
    from audiotools_tpu_torch.data import DataLoader

    ds = make_dataset(root, BATCH, use_original_phase=use_original_phase)
    t0 = time.perf_counter()
    batch = next(iter(DataLoader(ds, batch_size=BATCH, num_workers=8)))  # to the card by default
    torch.cuda.synchronize()
    print(f"[chain] first batch through DataLoader (8 workers, staged to the card; "
          f"use_original_phase={use_original_phase}): {time.perf_counter() - t0:.2f} s")
    expect(batch["signal"].device.type == "cuda",
           f"the loader staged the batch on {batch['signal'].device}, not the card")
    return ds, batch


def phase_chain(ds, batch, label, fast_meter, synthesis_method, must_launch):
    """One path on the staged batch: a warm-up run, then N_ITER timed runs.
    Launch counts are set to 0 just before the path and read just after."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    with meter(fast_meter):
        HK.reset_launch_counts()
        run_chain(ds, batch, synthesis_method)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        stages = np.zeros(4)
        t0 = time.perf_counter()
        for _ in range(N_ITER):
            marks = []
            audio, mel, lufs = run_chain(ds, batch, synthesis_method, marks=marks)
            torch.cuda.synchronize()
            stages += [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        wall_ms = (time.perf_counter() - t0) * 1000 / N_ITER
        launches = dict(HK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    stages /= N_ITER
    ms = float(stages.sum())
    tag = f"[chain {label}]"
    print(f"{tag} meter {'FIR through kernel C' if fast_meter else 'exact'}, synthesis "
          f"{synthesis_method}: {BATCH} x {DURATION:g} s @ {SR} Hz: {ms:.3f} ms/batch (CUDA "
          f"events; host wall {wall_ms:.3f} ms) | {BATCH / ms * 1000:.1f} clips/s | "
          f"{BATCH * DURATION / ms * 1000:.0f}x real time | peak {peak / 2**30:.3f} GiB "
          f"({resident / 2**30:.3f} GiB resident before the runs: the staged batches)")
    print(f"{tag} stages (ms): " + ", ".join(
        f"{n} {v:.3f}" for n, v in zip(("transforms", "pitch_shift", "mel", "loudness"), stages)))
    print(f"{tag} kernel launches ({N_ITER + 1} runs): {launches}")
    expect(all(launches[k] > 0 for k in must_launch),
           f"{label}: a kernel of the path was not launched: {launches}")
    n_frames = 1 + int(SR * DURATION) // 512
    expect(tuple(audio.shape) == (BATCH, 1, int(SR * DURATION)), f"audio shape {tuple(audio.shape)}")
    expect(tuple(mel.shape) == (BATCH, 1, 80, n_frames), f"mel shape {tuple(mel.shape)}")
    expect(tuple(lufs.shape) == (BATCH,), f"lufs shape {tuple(lufs.shape)}")
    for name, t in (("audio", audio), ("mel", mel), ("lufs", lufs)):
        expect(bool(torch.isfinite(t).all()), f"non-finite {name}")
    expect(bool(((lufs > -40) & (lufs < -10)).all()), f"implausible loudness {lufs.tolist()}")
    return launches


def _silence_led(items):
    """A copy of collated items whose clips start with ``SILENT_LEAD_S`` of
    exact zeros."""
    items = dict(items)
    signal = items["signal"].clone()
    audio = signal.audio_data.clone()
    audio[..., :int(SILENT_LEAD_S * SR)] = 0.0
    signal.audio_data = audio
    items["signal"] = signal
    return items


def phase_card_vs_cpu(ds, dev, ds_original_phase):
    """The chains on the card and on the CPU for the first N_CHECK clips,
    every sample held; the original-phase path also on silence-led copies
    of its clips."""
    from audiotools_tpu_torch.core import util

    items = util.collate([ds[i] for i in range(N_CHECK)])
    op_items = util.collate([ds_original_phase[i] for i in range(N_CHECK)])
    for label, d, its, fast_meter, method, tol in (
        ("main", ds, items, False, "matmul", CHAIN_TOL["matmul"]),
        ("main", ds, items, False, "matmul_bf16", CHAIN_TOL["matmul_bf16"]),
        ("parity", ds, items, True, "matmul_bf16_fused", CHAIN_TOL["matmul_bf16"]),
        ("original_phase", ds_original_phase, op_items, False, "matmul_bf16",
         CHAIN_TOL["matmul_bf16"]),
        (f"original_phase, first {SILENT_LEAD_S:g} s silent", ds_original_phase,
         _silence_led(op_items), False, "matmul_bf16", CHAIN_TOL["matmul_bf16"]),
    ):
        with meter(fast_meter):
            a_gpu, m_gpu, l_gpu = (t.cpu() for t in run_chain(
                d, util.prepare_batch(its, dev), synthesis_method=method))
            a_cpu, m_cpu, l_cpu = run_chain(
                d, util.prepare_batch(its, "cpu"), synthesis_method=method)
        err = {
            "audio_abs": float((a_gpu - a_cpu).abs().max()),
            "mel_rel": float((m_gpu - m_cpu).abs().max() / m_cpu.abs().max()),
            "lufs_db": float((l_gpu - l_cpu).abs().max()),
        }
        print(f"[card vs cpu] {label}: {N_CHECK} clips, meter {'FIR' if fast_meter else 'exact'}, "
              f"synthesis {method}, every sample: " + ", ".join(
                  f"{k} {v:.3e} (tol {tol[k]:g})" for k, v in err.items()))
        for k, v in err.items():
            expect(v <= tol[k], f"card vs CPU {k} {v:.3e} > {tol[k]:g} ({label}, {method})")


def _graph_has(t, node_name):
    """Whether the autograd graph behind ``t`` holds a node ``node_name``."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == node_name:
            return True
        stack.extend(f for f, _ in fn.next_functions)
    return False


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def phase_pitch_grad(audio):
    """R4 on the staged batch: d sum(w * pitch_shift(x, +2 st)) / dx with the
    fused vocoder (kernel B with its track, launched once, under a custom
    backward) against autograd of the ``phasor`` formulation; then the
    vocoder alone at its chain shape, d (|out|^2 + Re(w out)) / d spectrum.
    Launch counts are set to 0 just before the fused pitch shift's pass and
    read just after."""
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import resample as PR
    from audiotools_tpu_torch.ops import stretch as PS

    gen = torch.Generator(device=audio.device).manual_seed(11)
    w = torch.randn(audio.shape, generator=gen, device=audio.device)

    def pitch_grad(formulation):
        x = audio.detach().clone().requires_grad_(True)
        out = PS.pitch_shift(x, 2.0, SR, pv_formulation=formulation)
        (out * w).sum().backward()
        return x.grad, out

    HK.reset_launch_counts()
    g_fused, out = pitch_grad("phasor_fused")
    torch.cuda.synchronize()
    launches = dict(HK.LAUNCHES)
    through_b = _graph_has(out, "_FusedPhaseVocoderBackward")
    del out
    g_phasor, _ = pitch_grad("phasor")
    pitch_err = _rel(g_fused, g_phasor)
    del g_fused, g_phasor
    fused_ms = time_ms(lambda: pitch_grad("phasor_fused"), 3)
    phasor_ms = time_ms(lambda: pitch_grad("phasor"), 3)

    rate = 2.0 ** (-2.0 / 12.0)
    # the spectrum the pitch shift's vocoder sees: the audio resampled by
    # 49/55 (the +2 st ratio), (64, 1, 1025, 384)
    spec = PF.stft(PR.resample(audio, 55, 49), 2048, 512, method="matmul").detach()
    wv = None

    def vocoder_grad(formulation):
        nonlocal wv
        z = spec.clone().requires_grad_(True)
        out = PS.phase_vocoder(z, rate, 512, 2048, formulation=formulation)
        if wv is None:
            wv = torch.randn(out.shape, generator=gen, device=out.device)
        ((out.abs() ** 2).sum() + (out.real * wv).sum()).backward()
        return z.grad

    pv_err = _rel(vocoder_grad("phasor_fused"), vocoder_grad("phasor"))
    pv_fused_ms = time_ms(lambda: vocoder_grad("phasor_fused"), 3)
    pv_phasor_ms = time_ms(lambda: vocoder_grad("phasor"), 3)
    print(f"[pitch grad] {tuple(audio.shape)} +2 st, d sum(w * out) / dx: fused vs phasor "
          f"rel err {pitch_err:.3e} (tol {PITCH_GRAD_RTOL:g}) | fwd+bwd fused {fused_ms:.3f} ms, "
          f"phasor {phasor_ms:.3f} ms | kernel B under the custom backward: {through_b} | "
          f"launches (one fused pass): {launches}")
    n_steps = len(PS._pv_indices(spec.shape[-1], rate)[0])
    print(f"[pitch grad] vocoder alone {tuple(spec.shape)} -> {n_steps} steps: fused vs phasor rel "
          f"err {pv_err:.3e} (tol {PV_GRAD_RTOL:g}) | fwd+bwd fused {pv_fused_ms:.3f} ms, "
          f"phasor {pv_phasor_ms:.3f} ms")
    expect(launches["phase_vocoder_fused"] == 1 and through_b,
           f"the fused pitch shift's gradient did not go through kernel B once: {launches}")
    expect(sum(launches.values()) == 1, f"the pitch-shift gradient launched other kernels: {launches}")
    expect(pitch_err < PITCH_GRAD_RTOL, f"pitch-shift gradient: fused vs phasor {pitch_err:.3e}")
    expect(pv_err < PV_GRAD_RTOL, f"vocoder gradient: fused vs phasor {pv_err:.3e}")
    return launches, dict(pitch_err=pitch_err, pv_err=pv_err, fused_ms=fused_ms,
                          phasor_ms=phasor_ms, pv_fused_ms=pv_fused_ms, pv_phasor_ms=pv_phasor_ms)


def _adamw(module):
    # optax.adamw(1e-4)'s defaults; torch's default weight decay is 1e-2
    return torch.optim.AdamW(module.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _training_step(label, dev, seed=0, stft_method="matmul"):
    """Fresh seeded models on ``dev``, their optimizers, and the step of
    ``label`` ("reconstruction" or "adversarial"); ``stft_method`` is the
    MRD's analysis."""
    from audiotools_tpu_torch.models import DAC, Discriminator
    from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step
    from audiotools_tpu_torch.models.train import make_train_step

    gen = DAC(seed=seed).to(dev)
    if label == "reconstruction":
        return (gen,), make_train_step(gen, _adamw(gen), SR)
    disc = Discriminator(seed=seed + 1, stft_method=stft_method).to(dev)
    return (gen, disc), make_adversarial_train_step(gen, disc, _adamw(gen), _adamw(disc), SR)


def profile_step(step, audio, top=10):
    """One more step under ``torch.profiler``: its host wall, the kernels'
    summed device time and count (user annotations, which span kernels,
    left out), and the kernels that take the most device time. The profiler slows the
    host, so the caller sets the kernels' time against an unprofiled step's
    to read the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(audio)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1000
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [(e.key[:90], e.self_device_time_total / 1000, e.count) for e in kernels[:top]]
    return wall_ms, busy_ms, sum(e.count for e in kernels), rows


def phase_codec_training(root, dev, card):
    """The training path at full width: a batch from the loader, then each
    step TRAIN_STEPS times on fresh seeded models, the first untimed. Launch
    counts are set to 0 just before each path and read just after."""
    from audiotools_tpu_torch.data import DataLoader
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    ds = AudioDataset(AudioLoader(sources=[str(root / "spk.csv")]), sample_rate=SR,
                      n_examples=TRAIN_BATCH, duration=TRAIN_SAMPLES / SR)
    audio = next(iter(DataLoader(ds, batch_size=TRAIN_BATCH, num_workers=4)))["signal"].audio_data
    expect(tuple(audio.shape) == (TRAIN_BATCH, 1, TRAIN_SAMPLES) and audio.device.type == "cuda",
           f"training batch {tuple(audio.shape)} on {audio.device}")
    launches, results = {}, {}
    for label in ("reconstruction", "adversarial"):
        models, step = _training_step(label, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        HK.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = step(audio)  # untimed
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(TRAIN_STEPS - 1):
            metrics = step(audio)
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000 / (TRAIN_STEPS - 1)
        ms = start.elapsed_time(end) / (TRAIN_STEPS - 1)
        launches[label] = dict(HK.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        prof_wall, busy, n_kernels, rows = profile_step(step, audio)
        values = {k: float(v) for k, v in metrics.items()}
        n_params = sum(p.numel() for m in models for p in m.parameters())
        print(f"[train {label}] DAC(){' + Discriminator()' if len(models) > 1 else ''} "
              f"({n_params / 1e6:.2f} M parameters), {TRAIN_BATCH} x {TRAIN_SAMPLES}: {ms:.3f} "
              f"ms/step (CUDA events, {TRAIN_STEPS - 1} steps after one untimed of "
              f"{first_s:.2f} s; host wall {wall_ms:.3f} ms) | {TRAIN_BATCH / ms * 1000:.2f} "
              f"clips/s | peak {peak / 2**30:.3f} GiB | {card}")
        print(f"[train {label}] metrics: " + ", ".join(f"{k} {v:.5g}" for k, v in values.items())
              + f" | kernel launches: {launches[label]}")
        if busy > 0:
            print(f"[train {label}] profiled step (wall {prof_wall:.3f} ms): {n_kernels} kernels, "
                  f"{busy:.3f} ms a step, device idle {1 - busy / ms:.1%} of the unprofiled "
                  f"{ms:.3f} ms; "
                  f"by device time: " + "; ".join(
                      f"{name} {t:.3f} ms x{n}" for name, t, n in rows))
        else:
            print(f"[train {label}] profiled step: the profiler recorded no device time")
        expect(all(np.isfinite(v) for v in values.values()), f"{label}: non-finite {values}")
        results[label] = dict(ms=ms, wall_ms=wall_ms, peak=peak, first_s=first_s)
        del models, step, metrics
    return audio, launches, results


def _max_update_gap(card_models, cpu_models):
    """Largest parameter difference, and the share of entries differing by
    more than ``update_lr`` LR, between two copies after one step."""
    worst, over, total = 0.0, 0, 0
    for a, b in zip(card_models, cpu_models):
        for pa, pb in zip(a.parameters(), b.parameters()):
            if hasattr(pa, "full_tensor"):  # a DTensor: its global value
                pa = pa.full_tensor()
            diff = (pa.detach().cpu() - pb.detach().cpu()).abs()
            worst = max(worst, float(diff.max()))
            over += int((diff > TRAIN_TOL["update_lr"] * LR).sum())
            total += diff.numel()
    return worst, over / total


def _grad_norm(model):
    return float(torch.sqrt(sum((p.grad.detach().double().cpu() ** 2).sum()
                                for p in model.parameters() if p.grad is not None)))


def phase_training_card_vs_cpu(audio, dev, labels=("reconstruction", "adversarial"),
                               stft_method="matmul"):
    """One step of each training path at batch TRAIN_CHECK_BATCH, on the card
    and on the CPU, from the same seeded weights, in full fp32 on both, held
    to TRAIN_TOL; ``stft_method`` is the MRD's analysis."""
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    a_card = audio[:TRAIN_CHECK_BATCH].detach()
    a_cpu = a_card.cpu()
    with strict_fp32():
        for label in labels:
            card_models, card_step = _training_step(label, dev, stft_method=stft_method)
            cpu_models, cpu_step = _training_step(label, "cpu", stft_method=stft_method)
            err = {}
            if label == "reconstruction":
                gen_card, gen_cpu = card_models[0], cpu_models[0]
                with torch.no_grad():
                    z_card = gen_card.encoder(gen_card._pad(a_card))
                    z_cpu = gen_cpu.encoder(gen_cpu._pad(a_cpu))
                    err["latent_rel"] = _rel(z_card.cpu(), z_cpu)
                    _, codes_card = gen_card.encode(a_card)
                    _, codes_cpu = gen_cpu.encode(a_cpu)
                    agreement = float((codes_card.cpu() == codes_cpu).float().mean())
                    err["decoded_rel"] = _rel(gen_card.decode_from_codes(codes_cpu.to(dev)).cpu(),
                                              gen_cpu.decode_from_codes(codes_cpu))
                print(f"[train card vs cpu] {TRAIN_CHECK_BATCH} x {TRAIN_SAMPLES}: code agreement "
                      f"{agreement:.4%} of {codes_cpu.numel()} codes")
            m_card = {k: float(v) for k, v in card_step(a_card).items()}
            m_cpu = {k: float(v) for k, v in cpu_step(a_cpu).items()}
            err["loss_rel"] = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
            err["grad_norm_rel"] = abs(_grad_norm(card_models[0]) - _grad_norm(cpu_models[0])) / (
                _grad_norm(cpu_models[0]))
            worst, share = _max_update_gap(card_models, cpu_models)
            tag = label if stft_method == "matmul" else f"{label}, MRD stft_method={stft_method}"
            print(f"[train card vs cpu] {tag}: " + ", ".join(
                f"{k} {v:.3e} (tol {TRAIN_TOL[k]:g})" for k, v in err.items())
                + f" | after the step: largest parameter gap {worst / LR:.3f} LR (tol 2), share "
                f"over {TRAIN_TOL['update_lr']:g} LR {share:.2e} (tol {TRAIN_TOL['update_share']:g})"
                + f" | loss card {m_card['loss']:.6f}, cpu {m_cpu['loss']:.6f}")
            for k, v in err.items():
                expect(v <= TRAIN_TOL[k], f"training card vs CPU ({tag}) {k} {v:.3e}")
            expect(worst <= 2.01 * LR and share <= TRAIN_TOL["update_share"],
                   f"training card vs CPU ({tag}): parameters after the step differ "
                   f"({worst / LR:.3f} LR, share {share:.2e})")
            del card_models, cpu_models, card_step, cpu_step


# ---------------------------------------------------------------------------
# the single-pass bf16 analysis and the interpreter-mode names
# ---------------------------------------------------------------------------

# the bf16 analysis (stft(method="matmul_bf16")): card against CPU on the
# same bf16 operands, fp32 sums in other orders (1e-5 of the spectrum's
# scale); against the card's fp32 spectrum, more than fp32 rounding and less
# than the two bf16 roundings of frames and matrices (tests/test_torch_parallel.py)
BF16_STFT_TOL = {"card_vs_cpu_rel": 1e-5, "vs_fp32_min": 1e-6, "vs_fp32_max": 2.0 ** -8}
BF16_STFT_SHAPE = (2048, 512)  # the main path's window and hop
BF16_STFT_ITERS = 10
BF16_TRAIN_TURNS = 4  # each analysis's timed turns of the adversarial step, alternating


def phase_bf16_analysis(dev, card, chain_audio, train_audio, train_results):
    """The single-pass bf16 analysis on the card: the adversarial step with
    the MRD's STFT in bf16 at full width beside the fp32 one (in alternating
    turns), one step card against CPU, the analysis alone at the
    main path's shape, the two spectral losses, and the JAX package's
    interpreter-mode names. Launch counts are set to 0 just before each
    path and read just after."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.metrics.spectral import MelSpectrogramLoss, MultiScaleSTFTLoss
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops import stretch as PS
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    launches, results = {}, {}
    # 1. the adversarial step with each analysis, on one pair of seeded models
    # each, in alternating turns (the step's time drifts within a call)
    methods = ("matmul", "matmul_bf16")
    pairs = {m: _training_step("adversarial", dev, stft_method=m) for m in methods}
    for m in methods:  # untimed: the optimizers' state, cuDNN's first choices
        pairs[m][1](train_audio)
    times, peaks = {m: [] for m in methods}, {m: 0 for m in methods}
    HK.reset_launch_counts()
    for turn in range(BF16_TRAIN_TURNS):
        for m in methods if turn % 2 == 0 else methods[::-1]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(TRAIN_STEPS - 1):
                metrics = pairs[m][1](train_audio)
            end.record()
            end.synchronize()
            times[m].append(start.elapsed_time(end) / (TRAIN_STEPS - 1))
            peaks[m] = max(peaks[m], torch.cuda.max_memory_allocated() - resident)
            expect(all(np.isfinite(float(v)) for v in metrics.values()),
                   f"bf16 analysis step ({m}): non-finite metrics")
    launches["adversarial"] = dict(HK.LAUNCHES)
    ms = {m: float(np.median(times[m])) for m in methods}
    idle = {}
    for m in methods:
        _, busy, n_kernels, _ = profile_step(pairs[m][1], train_audio)
        idle[m] = f"{1 - busy / ms[m]:.1%} ({n_kernels} kernels)" if busy > 0 else "not measured"
    del pairs, metrics
    for m in methods:
        print(f"[bf16 train] adversarial step, MRD stft_method={m}, {TRAIN_BATCH} x "
              f"{TRAIN_SAMPLES}: median {ms[m]:.3f} ms/step of {BF16_TRAIN_TURNS} turns of "
              f"{TRAIN_STEPS - 1} steps ({', '.join(f'{t:.3f}' for t in times[m])}; CUDA events) "
              f"| {TRAIN_BATCH / ms[m] * 1000:.2f} clips/s | peak {peaks[m] / 2**30:.3f} GiB over "
              f"the resident models | device idle {idle[m]} of the median | {card}")
    print(f"[bf16 train] bf16 / fp32 analysis: step {ms['matmul_bf16'] / ms['matmul']:.4f}, peak "
          f"{peaks['matmul_bf16'] / peaks['matmul']:.4f} | phase 8's fp32 step "
          f"{train_results['ms']:.3f} ms, peak {train_results['peak'] / 2**30:.3f} GiB | kernel "
          f"launches: {launches['adversarial']}")
    results["adversarial"] = dict(ms=ms, times=times, peaks=peaks)

    # 2. one step card against CPU, held to TRAIN_TOL as the fp32 paths are
    phase_training_card_vs_cpu(train_audio, dev, labels=("adversarial",),
                               stft_method="matmul_bf16")

    # 3. the analysis alone at the main path's shape, card against CPU and fp32
    win, hop = BF16_STFT_SHAPE
    x = chain_audio.reshape(chain_audio.shape[0], -1)
    HK.reset_launch_counts()
    spec = PF.stft(x, win, hop, method="matmul_bf16")
    spec32 = PF.stft(x, win, hop, method="matmul")
    torch.cuda.synchronize()
    launches["stft"] = dict(HK.LAUNCHES)
    scale = float(spec32.abs().max())
    vs_fp32 = float((spec - spec32).abs().max()) / scale
    want = PF.stft(x[:N_CHECK].cpu(), win, hop, method="matmul_bf16")
    vs_cpu = float((spec[:N_CHECK].cpu() - want).abs().max() / want.abs().max())
    times = {}
    for method in ("matmul", "matmul_bf16", "matmul_bf16", "matmul"):
        times.setdefault(method, []).append(
            time_ms(lambda: PF.stft(x, win, hop, method=method), BF16_STFT_ITERS))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"[bf16 stft] {tuple(x.shape)}, n_fft {win}, hop {hop}: matmul_bf16 "
          f"{ms['matmul_bf16']:.4f} ms, matmul {ms['matmul']:.4f} ms (ratio "
          f"{ms['matmul_bf16'] / ms['matmul']:.4f}; CUDA events, {BF16_STFT_ITERS} calls a turn, "
          f"turns {[round(t, 4) for t in times['matmul']]} / "
          f"{[round(t, 4) for t in times['matmul_bf16']]}) | card vs CPU {vs_cpu:.3e} of scale "
          f"(tol {BF16_STFT_TOL['card_vs_cpu_rel']:g}) | vs the card's fp32 spectrum "
          f"{vs_fp32:.3e} of scale (within ({BF16_STFT_TOL['vs_fp32_min']:g}, "
          f"{BF16_STFT_TOL['vs_fp32_max']:.3e})) | kernel launches: {launches['stft']} | {card}")
    expect(tuple(spec.shape) == (x.shape[0], win // 2 + 1, 1 + x.shape[-1] // hop)
           and spec.dtype == torch.complex64, f"bf16 stft: {tuple(spec.shape)} {spec.dtype}")
    expect(bool(torch.isfinite(torch.view_as_real(spec)).all()), "bf16 stft: non-finite")
    expect(vs_cpu < BF16_STFT_TOL["card_vs_cpu_rel"], f"bf16 stft card vs CPU {vs_cpu:.3e}")
    expect(BF16_STFT_TOL["vs_fp32_min"] < vs_fp32 < BF16_STFT_TOL["vs_fp32_max"],
           f"bf16 stft vs fp32 {vs_fp32:.3e}")
    results["stft"] = dict(ms=ms, vs_cpu=vs_cpu, vs_fp32=vs_fp32)
    del spec, spec32, want

    # 4. the spectral losses on the training batch: value and gradient norm,
    # card against CPU on the same operands, held to TRAIN_TOL's bounds
    def loss_and_grad(audio, method):
        est = audio.detach().clone().requires_grad_(True)
        ref = audio.detach().flip(0)
        with strict_fp32():
            loss = (MelSpectrogramLoss(stft_method=method)(AudioSignal(est, SR),
                                                           AudioSignal(ref, SR))
                    + MultiScaleSTFTLoss(stft_method=method)(AudioSignal(est, SR),
                                                             AudioSignal(ref, SR)))
            loss.backward()
        return float(loss.detach()), est.grad

    HK.reset_launch_counts()
    card_loss, card_grad = loss_and_grad(train_audio, "matmul_bf16")
    launches["losses"] = dict(HK.LAUNCHES)
    cpu_loss, cpu_grad = loss_and_grad(train_audio.cpu(), "matmul_bf16")
    fp32_loss, fp32_grad = loss_and_grad(train_audio, "matmul")
    err = {"loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss),
           "grad_norm_rel": abs(float(card_grad.norm()) - float(cpu_grad.norm()))
           / float(cpu_grad.norm())}
    cosine = float((card_grad * fp32_grad).sum() / (card_grad.norm() * fp32_grad.norm()))
    print(f"[bf16 losses] MelSpectrogramLoss + MultiScaleSTFTLoss (stft_method=matmul_bf16) on "
          f"{tuple(train_audio.shape)}: loss card {card_loss:.6f}, cpu {cpu_loss:.6f}; gradient "
          f"norm card {float(card_grad.norm()):.6g}, cpu {float(cpu_grad.norm()):.6g} | "
          + ", ".join(f"{k} {v:.3e} (tol {TRAIN_TOL[k]:g})" for k, v in err.items())
          + f" | beside the fp32 losses on the card: loss {fp32_loss:.6f}, gradient norm "
          f"{float(fp32_grad.norm()):.6g}, cosine {cosine:.4f} | kernel launches: "
          f"{launches['losses']}")
    expect(np.isfinite(card_loss) and bool(torch.isfinite(card_grad).all()),
           "bf16 losses: non-finite value or gradient")
    for k, v in err.items():
        expect(v <= TRAIN_TOL[k], f"bf16 losses card vs CPU {k} {v:.3e}")
    results["losses"] = dict(err, cosine=cosine)

    # 5. the interpreter-mode names: each kernel's plain version, bit for bit
    audio = chain_audio[:, 0]
    taps = PL._composed_fir_on(SR, "K-weighting", 512, audio.device)
    spec = PF.stft(audio, win, hop, method="matmul")
    n_frames = spec.shape[-1]
    i0, i1, frac = PS._pv_indices(n_frames, 2.0 ** (-2.0 / 12.0))
    (w,) = PF._on_device(PF._synthesis_design, ("hann", win, hop), audio.device)
    (inv_env,) = PF._on_device(PF._inverse_envelope, ("hann", win, hop, n_frames), audio.device)
    length = audio.shape[-1]
    HK.reset_launch_counts()
    names = {
        "pallas_interpret (meter)": (
            lambda: PL.apply_k_weighting(audio, SR, use_fir=True, conv_method="pallas_interpret"),
            lambda: HK.fir_causal_plain(audio, taps)),
        "phasor_fused_interpret": (
            lambda: PS.phase_vocoder(spec, 2.0 ** (-2.0 / 12.0), hop, win,
                                     formulation="phasor_fused_interpret"),
            lambda: HK.phase_vocoder_fused_plain(spec, i0, i1, frac)),
        "matmul_bf16_fused_interpret": (
            lambda: PF.istft(spec, win, hop, length=length, method="matmul_bf16_fused_interpret"),
            lambda: HK.istft_synthesis_fused_plain(spec.transpose(-1, -2), w, hop, inv_env)[
                :, win // 2: win // 2 + length]),
    }
    interpret = {}
    for name, (route, plain) in names.items():
        got, want = route(), plain()
        expect(got.device.type == "cuda", f"{name} computed on {got.device}")
        interpret[name] = bool(torch.equal(got, want))
    torch.cuda.synchronize()
    launches["interpret"] = dict(HK.LAUNCHES)
    print(f"[bf16 interpret] on the card, {tuple(audio.shape)} (n_fft {win}, hop {hop}), each "
          f"name against its kernel's plain version called directly: "
          + ", ".join(f"{k} {'bit-equal' if v else 'DIFFERS'}" for k, v in interpret.items())
          + f" | kernel launches: {launches['interpret']}")
    expect(all(interpret.values()), f"interpreter-mode names off their plain versions: {interpret}")
    expect(sum(launches["interpret"].values()) == 0,
           f"an interpreter-mode name launched a kernel: {launches['interpret']}")
    return launches, results


# ---------------------------------------------------------------------------
# serving and evaluation
# ---------------------------------------------------------------------------


def _timed(fn):
    """``fn``'s result, ms (CUDA events), host wall ms, the peak allocation
    and its increment over the allocation before the call: one call after an
    untimed one, the peak statistics reset before it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) * 1000
    peak = torch.cuda.max_memory_allocated()
    return out, start.elapsed_time(end), wall, peak, peak - base


def _conv_flops(model, fn):
    """``fn()``'s result and the operations of the model's convolutions in
    it (2 per multiply-add), counted from their shapes by forward hooks."""
    from torch import nn

    total = [0]

    def count(layer, inputs, out):
        if isinstance(layer, nn.ConvTranspose1d):
            total[0] += 2 * inputs[0].numel() * layer.out_channels * layer.kernel_size[0]
        else:
            total[0] += 2 * out.numel() * layer.in_channels * layer.kernel_size[0]

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d))]
    try:
        return fn(), total[0]
    finally:
        for hook in hooks:
            hook.remove()


def _vq_gaps(model, audio):
    """The whole pass's pre-quantization latents and, per stage and frame,
    the gap between the two best codeword similarities relative to the best,
    ``(B, n_q, frames)``."""
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    with torch.no_grad(), strict_fp32():
        z = model.encoder(model._pad(audio))
        residual, gaps = z, []
        for vq in model.quantizer.quantizers:
            z_e = vq.in_proj(residual.transpose(1, 2))
            z_n = z_e / (torch.linalg.vector_norm(z_e, dim=-1, keepdim=True) + 1e-8)
            c_n = vq.codebook / (torch.linalg.vector_norm(vq.codebook, dim=-1, keepdim=True) + 1e-8)
            top = torch.topk(z_n @ c_n.T, 2, dim=-1).values
            gaps.append((top[..., 0] - top[..., 1]) / top[..., 0].abs())
            residual = residual - vq(residual)[0]
    return z, torch.stack(gaps, dim=1)


def _code_mismatch(label, codes, want, gaps):
    """Compare two code tensors ``(B, n_q, frames)``. A frame whose codes
    differ is excused when the whole pass's gap at its first differing stage
    is within SERVE_TOL["margin_rel"]: there fp32 rounding picks the code
    (and the later stages follow from it). Returns the frames that count."""
    codes, want, gaps = codes.cpu(), want.cpu(), gaps.cpu()
    expect(codes.shape == want.shape, f"{label}: codes {tuple(codes.shape)} vs {tuple(want.shape)}")
    diff = codes != want
    frames = diff.any(dim=1)
    gap = torch.gather(gaps, 1, diff.int().argmax(dim=1, keepdim=True))[:, 0]
    counted = int((frames & (gap > SERVE_TOL["margin_rel"])).sum())
    print(f"[serve] {label}: {int(diff.sum())} of {diff.numel()} codes differ, in "
          f"{int(frames.sum())} frames; {counted} count against the check; gaps at the first "
          f"differing stage: {[f'{g:.2e}' for g in gap[frames].tolist()[:12]]}")
    expect(counted == 0, f"{label}: {counted} frames' codes differ beyond rounding")
    return counted


def _streamed_latents(model, audio, chunk):
    """The encoder's latents through the streaming window geometry."""
    from audiotools_tpu_torch.models import streaming
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    hop, halo = model.hop_length, streaming.encoder_halo_frames(model)
    x = model._pad(audio)
    W, out = chunk + 2 * halo, []
    with torch.no_grad(), strict_fp32():
        for start, lo, hi in streaming._window_starts(x.shape[-1] // hop, chunk, halo, W):
            out.append(model.encoder(x[..., start * hop: (start + W) * hop].contiguous())[..., lo:hi])
    return torch.cat(out, dim=-1)


def _metric_parts(orig, recon):
    """STOI (scores, retained frames), PESQ wb (scores, delays) and raw NSIM
    in both modes of ``(original, reconstruction)`` through the device
    programs, on the signals' device."""
    from audiotools_tpu_torch.ops import nsim, pesq, stoi

    def at(signal, rate):
        return signal.clone().to_mono().resample(rate).audio_data[:, 0, :]

    out = {"stoi": stoi._stoi_parts(at(orig, stoi.FS), at(recon, stoi.FS), False),
           "estoi": stoi._stoi_parts(at(orig, stoi.FS), at(recon, stoi.FS), True),
           "pesq": pesq._pesq_parts(*pesq._checked_pair(at(orig, 16000), at(recon, 16000), "wb"),
                                    "wb")}
    for mode in ("audio", "speech"):
        fs = nsim.MODES[mode]["fs"]
        out[f"nsim_{mode}"] = (nsim.nsim_batch(at(orig, fs), at(recon, fs), mode=mode),)
    return {k: tuple(v.cpu() for v in vals) for k, vals in out.items()}


def phase_serving(root, dev, card):
    """The codec's serving and evaluation path at full width: DAC() saved and
    loaded back, the batch compressed and decompressed whole and streamed,
    the artifact round trip, the pairs scored; then items 0-1 on the CPU and
    through the host oracles. Launch counts are set to 0 just before and read
    just after (this path runs kernel G, the DAC's Snakes, alone)."""
    import warnings

    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.metrics import quality as Q
    from audiotools_tpu_torch.metrics._pesq import _MODES
    from audiotools_tpu_torch.models import (DAC, StreamingEncoder, compress, decompress,
                                             load_artifact, save_artifact)
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    warnings.filterwarnings("ignore", message=".*in-package.*")  # uncertified-scale notices
    HK.reset_launch_counts()
    t0 = time.perf_counter()
    host_model = DAC(**SERVE_MODEL)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    folder = host_model.save_to_folder(root / "serve")
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, _ = DAC.load_from_folder(root / "serve")
    load_s = time.perf_counter() - t0
    host_sd = host_model.state_dict()
    same = all(torch.equal(host_sd[k], v.cpu()) for k, v in model.state_dict().items())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] DAC({SERVE_MODEL or ''}) {n_params / 1e6:.2f} M parameters: init {init_s:.2f} s, "
          f"save_to_folder {save_s:.2f} s ({sum(f.stat().st_size for f in folder.iterdir()) / 2**20:.1f}"
          f" MiB), load_from_folder to {model.device} {load_s:.2f} s; weights bit-equal: {same}")
    expect(same and model.device.type == "cuda", "load_from_folder did not restore the weights on the card")

    n = int(SERVE_SECONDS * SR)
    orig = AudioSignal(np.stack([speech_like(300 + i, SERVE_SECONDS) for i in range(SERVE_BATCH)])[:, None],
                       SR)
    expect(orig.device.type == "cuda", f"signals on {orig.device}")
    audio_s = SERVE_BATCH * SERVE_SECONDS
    frames = -(-n // model.hop_length)

    def report(label, ms, wall, peak, inc):
        print(f"[serve] {label}: {ms:.3f} ms (CUDA events; host wall {wall:.3f}), RTF "
              f"{ms / 1000 / audio_s:.3e} (compute / audio), {audio_s / (ms / 1000):.1f}x real time | "
              f"peak {peak / 2**30:.3f} GiB, +{inc / 2**30:.3f} GiB over the call's start | {card}")

    res = {}
    art, *res["compress"] = _timed(lambda: compress(model, orig))
    art_s, *res["compress streamed"] = _timed(
        lambda: compress(model, orig, streaming=True, chunk_frames=SERVE_CHUNK))
    for label in ("compress", "compress streamed"):
        report(f"{label} {SERVE_BATCH} x {n} ({frames} code frames)", *res[label])
    expect(art["codes"].shape == (SERVE_BATCH, model.n_codebooks, frames),
           f"codes {art['codes'].shape}")
    whole = torch.from_numpy(art["codes"].astype(np.int64))
    z, gaps = _vq_gaps(model, orig.audio_data)
    _code_mismatch("streamed vs whole codes", torch.from_numpy(art_s["codes"].astype(np.int64)), whole,
                   gaps)
    z_s = _streamed_latents(model, orig.audio_data, SERVE_CHUNK)
    latent_rel = float((z_s - z).abs().max() / z.abs().max())
    print(f"[serve] streamed vs whole latents: {latent_rel:.3e} of the largest (tol "
          f"{SERVE_TOL['latent_rel']:g})")
    expect(latent_rel <= SERVE_TOL["latent_rel"], f"streamed latents {latent_rel:.3e}")
    del z, z_s

    rng = np.random.RandomState(12)
    enc, pushed, pieces, pos = StreamingEncoder(model, SERVE_BATCH, SERVE_CHUNK), 0, [], 0
    while pos < n:
        step = int(rng.uniform(*SERVE_BLOCKS) * SR)
        pieces += list(enc.push(orig.audio_data[:, :, pos: pos + step]))
        pos, pushed = pos + step, pushed + 1
    pieces += list(enc.flush())
    _code_mismatch(f"StreamingEncoder ({pushed} pushes of {SERVE_BLOCKS[0]}-{SERVE_BLOCKS[1]} s) "
                   "vs whole codes", torch.cat(pieces, dim=-1), whole, gaps)
    del pieces, enc

    path = save_artifact(str(root / "serve" / "clips.npz"), art)
    back = load_artifact(path)
    expect(back.keys() == art.keys() and np.array_equal(back["codes"], art["codes"])
           and all(back[k] == art[k] for k in art if k != "codes"), "artifact round trip")
    print(f"[serve] artifact: {Path(path).stat().st_size / 2**20:.3f} MiB on disk for "
          f"{audio_s:.0f} s of audio ({art['codes'].dtype}, {SERVE_BATCH * n * 2 / Path(path).stat().st_size:.1f}x"
          f" smaller than 16-bit PCM)")

    recon, *res["decompress"] = _timed(lambda: decompress(model, back))
    recon_s, *res["decompress streamed"] = _timed(
        lambda: decompress(model, back, streaming=True, chunk_frames=SERVE_CHUNK))
    for label in ("decompress", "decompress streamed"):
        report(f"{label} {SERVE_BATCH} x {frames} frames -> {n} samples", *res[label])
    audio_gap = float((recon_s.audio_data - recon.audio_data).abs().max())
    print(f"[serve] streamed vs whole audio: {audio_gap:.3e} abs (tol {SERVE_TOL['audio_abs']:g}); "
          f"reconstruction peak {float(recon.audio_data.abs().max()):.4f}")
    expect(recon.audio_data.shape == orig.audio_data.shape and bool(torch.isfinite(recon.audio_data).all()),
           f"reconstruction {tuple(recon.audio_data.shape)}")
    expect(audio_gap <= SERVE_TOL["audio_abs"], f"streamed audio {audio_gap:.3e}")
    del recon_s

    calls = {
        "stoi_device": lambda: Q.stoi_device(recon, orig),
        "stoi_device extended": lambda: Q.stoi_device(recon, orig, extended=True),
        "pesq_device wb": lambda: Q.pesq_device(recon, orig, mode="wb"),
        "visqol nsim audio": lambda: Q.visqol(recon, orig, mode="audio", backend="nsim"),
        "visqol nsim speech": lambda: Q.visqol(recon, orig, mode="speech", backend="nsim"),
    }
    scores = {}
    for label, fn in calls.items():
        scores[label], ms, wall, peak, _ = _timed(fn)
        res[label] = (ms, wall, peak)
        print(f"[eval] {label}: {ms:.3f} ms (host wall {wall:.3f}), {SERVE_BATCH / (ms / 1000):.2f} "
              f"pairs/s, peak {peak / 2**30:.3f} GiB | scores {[round(v, 5) for v in scores[label].tolist()]}"
              f" | {card}")
        expect(scores[label].shape == (SERVE_BATCH,) and bool(torch.isfinite(scores[label]).all()),
               f"{label}: {scores[label]}")
    launches = dict(HK.LAUNCHES)

    # items 0-1 on the CPU: the codec through the same entry points, with
    # the card's decode in float64 as the reference both fp32 decodes sit
    # around; then the metrics, against the float64 host oracles and on
    # the CPU, on the reconstructions and on a control pair (each clip at
    # 20 dB SNR: delay 0, where device PESQ reproduces the host's trim)
    k = SERVE_CHECK
    orig_k = AudioSignal(orig.audio_data[:k], SR)
    orig_cpu = AudioSignal(orig.audio_data[:k].cpu(), SR)
    t0 = time.perf_counter()
    art_cpu = compress(host_model, orig_cpu)
    recon_host = decompress(host_model, dict(art, codes=art["codes"][:k]))
    cpu_s = time.perf_counter() - t0
    _code_mismatch(f"card vs CPU codes (items 0-{k - 1})",
                   torch.from_numpy(art_cpu["codes"].astype(np.int64)), whole[:k], gaps[:k])
    model64 = copy.deepcopy(model).double()
    with torch.no_grad():
        ref64 = model64.decode_from_codes(whole[:k].to(dev))[..., :n].cpu()
    del model64
    card_gap = float((recon.audio_data[:k].cpu().double() - ref64).abs().max())
    cpu_gap = float((recon_host.audio_data.double() - ref64).abs().max())
    audio_cpu_gap = float((recon_host.audio_data - recon.audio_data[:k].cpu()).abs().max())
    bound = SERVE_TOL["device_rel"] * float(ref64.abs().max())
    print(f"[serve card vs cpu] items 0-{k - 1}: decompressed audio {audio_cpu_gap:.3e} abs (tol "
          f"{bound:.3e}: {SERVE_TOL['device_rel']:g} of the largest, {float(ref64.abs().max()):.4f}); "
          f"from the float64 decode: card {card_gap:.3e}, CPU {cpu_gap:.3e}; the CPU's compress + "
          f"decompress took {cpu_s:.2f} s")
    expect(max(audio_cpu_gap, card_gap, cpu_gap) <= bound,
           f"card vs CPU audio {audio_cpu_gap:.3e}, from float64 {card_gap:.3e} / {cpu_gap:.3e}")

    noise = torch.from_numpy(np.random.RandomState(13).randn(k, 1, n).astype(np.float32)).to(dev)
    control = orig_k.audio_data + noise * orig_k.audio_data.std(dim=-1, keepdim=True) / 10.0
    hop = _MODES["wb"].hop
    for pair, est in (("reconstruction", AudioSignal(recon.audio_data[:k], SR)),
                      ("control +20 dB noise", AudioSignal(control, SR))):
        est_cpu = AudioSignal(est.audio_data.cpu(), SR)
        card_parts, cpu_parts = _metric_parts(orig_k, est), _metric_parts(orig_cpu, est_cpu)
        delays = card_parts["pesq"][1]
        for label, got, want in (
                ("stoi", Q.stoi_device(est, orig_k), Q.stoi(est_cpu, orig_cpu)),
                ("estoi", Q.stoi_device(est, orig_k, extended=True),
                 Q.stoi(est_cpu, orig_cpu, extended=True)),
                ("pesq", Q.pesq_device(est, orig_k), Q.pesq(est_cpu, orig_cpu, backend="native"))):
            gap = (got.cpu().double() - want.cpu()).abs()
            tol = SERVE_TOL["pesq" if label == "pesq" else "stoi"]
            held = [i for i in range(k) if label != "pesq" or delays[i] >= 0 or delays[i] % hop == 0]
            print(f"[eval {pair}] {label} device vs the float64 host oracle: {gap.tolist()} (tol {tol:g};"
                  f" held on items {held}{f', delays {delays.tolist()}' if label == 'pesq' else ''})")
            expect(all(gap[i] <= tol for i in held), f"{pair}: {label} vs host oracle {gap.tolist()}")
        for key, tol in (("stoi", "stoi"), ("estoi", "stoi"), ("pesq", "pesq"), ("nsim_audio", "nsim"),
                         ("nsim_speech", "nsim")):
            err = float((card_parts[key][0] - cpu_parts[key][0]).abs().max())
            line = f"[eval {pair} card vs cpu] {key}: {err:.3e} (tol {SERVE_TOL[tol]:g})"
            expect(err <= SERVE_TOL[tol], f"{pair}: card vs CPU {key} {err:.3e}")
            if len(card_parts[key]) > 1:
                what = "delays" if key == "pesq" else "retained frames"
                line += f"; {what} card {card_parts[key][1].tolist()}, cpu {cpu_parts[key][1].tolist()}"
                expect(torch.equal(card_parts[key][1], cpu_parts[key][1]), f"{pair}: card vs CPU {what}")
            print(line)
    # last, so the profiler cannot touch the timings above
    for label, fn in (("compress", lambda: compress(model, orig)),
                      ("decompress", lambda: decompress(model, back))):
        flops = _conv_flops(model, fn)[1]
        ms = res[label][0]
        prof_wall, busy, n_kernels, rows = profile_step(lambda _: fn(), None, top=6)
        print(f"[serve] {label}, whole: convolutions {flops / 1e12:.3f} TFLOP, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, bound {flops / FP32_FLOPS * 1e3:.1f} ms at the fp32 "
              f"peak ({flops / FP32_FLOPS * 1e3 / ms:.1%} of it reached); profiled (wall "
              f"{prof_wall:.3f} ms): {n_kernels} kernels, {busy:.3f} ms on the device, idle "
              f"{1 - busy / ms:.1%} of the unprofiled call; by device time: "
              + "; ".join(f"{k} {t:.3f} ms x{c}" for k, t, c in rows))
    print(f"[launches] serving and evaluation: {launches} (kernel G, the DAC's Snakes, alone)")
    del model, host_model, recon, orig
    return launches, res


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------


def _host_tree(obj):
    """A host copy of a state tree (tensors cloned to the CPU, a DTensor's
    global value)."""
    if isinstance(obj, torch.Tensor):
        if hasattr(obj, "full_tensor"):
            obj = obj.full_tensor()
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_tree(v) for v in obj)
    return copy.deepcopy(obj)


def _tree_mismatches(got, want, path=""):
    """Paths where two state trees differ (tensors bit for bit)."""
    if isinstance(want, torch.Tensor):
        same = (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and got.shape == want.shape and torch.equal(got, want))
        return [] if same else [path]
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path]
        return [m for k in want for m in _tree_mismatches(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [path]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in _tree_mismatches(g, w, f"{path}/{i}")]
    return [] if got == want else [path]


def _loop_snapshot(params, opt_state, tracker_state):
    """Both nets' parameters, both AdamW states (moments and step counts) and
    the tracker's state, copied to the host."""
    return {"params": {k: _host_tree(m.state_dict()) for k, m in params.items()},
            "opt_state": {k: _host_tree(o.state_dict()) for k, o in opt_state.items()},
            "tracker": _host_tree(tracker_state)}


def _tracker_cost(dev, metrics, n=50):
    """Host ms a step that the Tracker adds (``track`` and ``log`` of one
    step's metrics, tensors on the card already computed), with the display
    that is installed and with the plain-text one; the display's output is
    dropped."""
    import io

    from audiotools_tpu_torch.ml.decorators import Tracker

    values = {k: torch.tensor(float(v), device=dev) for k, v in metrics.items()}
    torch.cuda.synchronize()
    cost = {}
    for display in ("installed", "plain"):
        rich = sys.modules.get("rich", False)
        if display == "plain":
            sys.modules["rich"] = None  # import rich fails: the plain display
        try:
            tracker = Tracker()
            step = tracker.log("train")(tracker.track("train", n)(lambda: dict(values)))
            with contextlib.redirect_stdout(io.StringIO()), tracker.live:
                t0 = time.perf_counter()
                for i in range(n):
                    tracker.step = i
                    step()
                cost[f"{display} ({'rich' if tracker.rich else 'plain'})"] = (
                    (time.perf_counter() - t0) * 1000 / n)
        finally:
            if rich is False:
                sys.modules.pop("rich", None)
            else:
                sys.modules["rich"] = rich
    return cost


def phase_training_loop(root, dev, card):
    """The canonical loop through its entry point: 6 fp32 steps with
    checkpoints, a resume from step 3 to 6, 3 bf16 steps, one traced step.
    Launch counts are set to 0 just before each loop and read just after."""
    import os
    import shutil

    from audiotools_tpu_torch.data import hostprof
    from audiotools_tpu_torch.examples import train_dac
    from audiotools_tpu_torch.ml import profiling
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    t_phase = time.perf_counter()
    on_card = {"batch": set(), "params": set()}
    last = {}  # the last step function and batch, for one profiled step after a loop
    probe = {}  # the running loop's steps, saves and restore
    snapshots = {}
    real_build, real_checkpointer = train_dac.build, train_dac.Checkpointer

    def fed(loader):
        """The loader's batches, each recorded as it arrives: its dataset
        indices, the seconds the loop waited for it, a CUDA event, and the
        host seconds until the loop asks for the next one (its save left out)."""
        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return
            t1 = time.perf_counter()
            rec = {"idx": [int(i) for i in batch["idx"]], "wait_s": t1 - t0,
                   "start": torch.cuda.Event(enable_timing=True), "save_s": 0.0}
            rec["start"].record()
            probe["steps"].append(rec)
            try:
                yield batch
            finally:
                rec["wall_s"] = time.perf_counter() - t1 - rec["save_s"]

    def build(args):
        """The loop's own build, its loader recorded and its step function
        checking where the batch lies and marking the step's end."""
        run = real_build(args)
        step_fn, prepare = run.step_fn, run.accel.prepare_dataloader

        def checked(audio):
            on_card["batch"].add(audio.device.type)
            last.update(step=step_fn, audio=audio)
            out = step_fn(audio)
            probe["steps"][-1]["end"] = torch.cuda.Event(enable_timing=True)
            probe["steps"][-1]["end"].record()
            return out

        run.step_fn = checked
        run.accel.prepare_dataloader = lambda *a, **kw: fed(prepare(*a, **kw))
        return run

    class Checkpointer(real_checkpointer):
        """The loop's own checkpointer, its saves and restore timed, and the
        state it saves at step 3 of the fp32 run and restores kept."""

        def save(self, step, params, opt_state=None, tracker=None, **kwargs):
            t0 = time.perf_counter()
            folder = super().save(step, params, opt_state, tracker=tracker, **kwargs)
            seconds = time.perf_counter() - t0
            probe["saves"].append({"step": step, "seconds": seconds, "bytes": sum(
                f.stat().st_size for f in folder.iterdir())})
            if probe["steps"]:
                probe["steps"][-1]["save_s"] += seconds
            if probe["snapshot"] and step == LOOP_CKPT_EVERY:
                snapshots["saved"] = _loop_snapshot(params, opt_state, tracker.state_dict())
            return folder

        def restore(self, step=None, template=None):
            t0 = time.perf_counter()
            state, meta = super().restore(step, template)
            probe["restored"] = {"step": meta["step"], "data_idx": meta["data_idx"],
                                 "seconds": time.perf_counter() - t0}
            snapshots["restored"] = _loop_snapshot(template["params"], template["opt_state"],
                                                   meta["tracker"])
            return state, meta

    def loop(label, ckpt_dir, steps, *extra, snapshot=False, profile=False):
        args = train_dac.parse_args([
            "--sources", str(root / "spk.csv"), "--steps", str(steps),
            "--batch-size", str(LOOP_BATCH), "--sample-rate", str(SR),
            "--num-workers", str(LOOP_WORKERS), "--ckpt-every", str(LOOP_CKPT_EVERY),
            "--ckpt-dir", str(ckpt_dir), "--adversarial", *extra])
        probe.clear()
        probe.update(steps=[], saves=[], restored=None, snapshot=snapshot)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hostprof.reset()
        hostprof.enable()
        HK.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            run = train_dac.main(args)
        finally:
            hostprof.disable()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(HK.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        spans = hostprof.totals()
        hostprof.reset()
        on_card["params"] |= {p.device.type for m in run.params.values() for p in m.parameters()}
        recs = probe["steps"]
        ms = [r["start"].elapsed_time(r["end"]) for r in recs]
        waits = [r["wait_s"] / (r["wait_s"] + r["wall_s"]) for r in recs]
        history = {k: list(v) for k, v in run.tracker.history["train"].items()}
        losses = {k: v for k, v in history.items() if k.startswith("loss")}
        steady = ms[1:] or ms
        restored = probe["restored"]
        print(f"[loop {label}] {len(recs)} steps of DAC() + Discriminator(), {LOOP_BATCH} x "
              f"{run.T}: first step {ms[0]:.3f} ms, then {np.mean(steady):.3f} ms/step (CUDA "
              f"events: {', '.join(f'{v:.3f}' for v in ms)}) | host wall {wall_s:.2f} s with "
              f"build and saves | peak {peak / 2**30:.3f} GiB | {card}")
        print(f"[loop {label}] loader wait share of each step's wall: "
              f"{', '.join(f'{w:.3f}' for w in waits)}; host spans (s): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(spans.items())))
        print(f"[loop {label}] saves: " + "; ".join(
            f"step {sv['step']} {sv['bytes'] / 2**20:.1f} MiB in {sv['seconds']:.2f} s"
            for sv in probe["saves"]) + (f" | restored step {restored['step']} (data idx "
                                         f"{restored['data_idx']}) in {restored['seconds']:.2f} s"
                                         if restored else "")
              + f" | kernel launches: {launches}")
        for k, v in losses.items():
            expect(all(np.isfinite(v)), f"loop {label}: non-finite {k} {v}")
        if profile:  # one more step of the loop's own step function, profiled
            prof_wall, busy, n_kernels, rows = profile_step(last["step"], last["audio"])
            print(f"[loop {label}] profiled step (wall {prof_wall:.3f} ms): {n_kernels} kernels, "
                  f"{busy:.3f} ms a step, device idle {1 - busy / np.mean(steady):.1%} of the "
                  f"loop's {np.mean(steady):.3f} ms; by device time: " + "; ".join(
                      f"{name} {t:.3f} ms x{n}" for name, t, n in rows))
        last.clear()
        out = dict(ms=ms, waits=waits, spans=spans, peak=peak, restored=restored,
                   idx=[r["idx"] for r in recs], history=history, launches=launches,
                   wall_s=wall_s, T=run.T, steps=run.ckpt.steps())
        del run
        return out

    train_dac.build, train_dac.Checkpointer = build, Checkpointer
    try:
        res = {"fp32": loop("fp32", root / "loop_a", LOOP_STEPS, snapshot=True, profile=True)}
        # the run is killed after step 3: its folder holds that step alone
        shutil.copytree(root / "loop_a" / str(LOOP_CKPT_EVERY),
                        root / "loop_b" / str(LOOP_CKPT_EVERY), copy_function=os.link)
        res["resumed"] = loop("resumed", root / "loop_b", LOOP_STEPS)
        res["bf16"] = loop("bf16", root / "loop_c", LOOP_AMP_STEPS, "--amp", profile=True)
        with profiling.trace(root / "trace"):
            res["traced"] = loop("traced", root / "loop_d", 1)
    finally:
        train_dac.build, train_dac.Checkpointer = real_build, real_checkpointer

    a, b = res["fp32"], res["resumed"]
    expect(a["T"] == 16384, f"loop length {a['T']}, not 16,384 samples")
    expect(a["steps"] == [LOOP_CKPT_EVERY, LOOP_STEPS], f"checkpoints kept {a['steps']}")
    mismatch = _tree_mismatches(snapshots.get("restored"), snapshots.get("saved"))
    restored = b["restored"] or {}
    print(f"[loop] restored state against the state saved at step {LOOP_CKPT_EVERY}: "
          f"{len(mismatch)} differing entries of parameters, AdamW moments and steps, and "
          f"tracker history{': ' + ', '.join(mismatch[:5]) if mismatch else ''}; data idx "
          f"{restored.get('data_idx')} (step 4's first index {a['idx'][LOOP_CKPT_EVERY][0]})")
    expect(not mismatch and restored.get("step") == LOOP_CKPT_EVERY,
           f"loop: the restored state differs from the saved one at {mismatch[:5]}")
    saved_history = (snapshots.get("saved") or {}).get("tracker", {}).get("history", {})
    live = {k: v[:LOOP_CKPT_EVERY] for k, v in b["history"].items()}
    expect(live == saved_history.get("train"),
           "loop: the resumed tracker's first steps differ from the saved history")
    expect(restored.get("data_idx") == LOOP_CKPT_EVERY * LOOP_BATCH == a["idx"][LOOP_CKPT_EVERY][0],
           f"loop: resumed at data idx {restored.get('data_idx')}")
    expect(b["idx"] == a["idx"][LOOP_CKPT_EVERY:],
           f"loop: the resumed run was fed {b['idx']}, the whole run {a['idx'][LOOP_CKPT_EVERY:]}")
    for label in ("fp32", "resumed"):
        counts = {k: len(v) for k, v in res[label]["history"].items()}
        expect(set(counts.values()) == {LOOP_STEPS}, f"loop {label}: history lengths {counts}")
    traces = [f for f in (root / "trace").rglob("*.json") if f.stat().st_size > 0]
    print(f"[loop] trace files: " + ", ".join(f"{f.name} {f.stat().st_size / 2**20:.1f} MiB"
                                              for f in traces))
    expect(bool(traces), "loop: profiling.trace wrote no trace file")
    expect(on_card["batch"] == {"cuda"} and on_card["params"] == {"cuda"},
           f"loop: batches on {on_card['batch']}, parameters on {on_card['params']}")
    step_metrics = {k: v[-1] for k, v in a["history"].items() if k != "step"}
    cost = _tracker_cost(dev, step_metrics)
    print(f"[loop] Tracker's host cost a step ({len(step_metrics)} scalars, 50 steps): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in cost.items()))
    fp32_ms, bf16_ms = np.mean(a["ms"][1:]), np.mean(res["bf16"]["ms"][1:])
    launches = {k: sum(r["launches"][k] for r in res.values()) for k in HK.LAUNCHES}
    print(f"[loop] bf16 {bf16_ms:.3f} against fp32 {fp32_ms:.3f} ms/step ({bf16_ms / fp32_ms:.3f}x); "
          f"peak bf16 {res['bf16']['peak'] / 2**30:.3f} against fp32 {a['peak'] / 2**30:.3f} GiB "
          f"| phase {time.perf_counter() - t_phase:.1f} s | {card}")
    print(f"[launches] training loop: {launches} (none of the TPU kernels' ports lies on this "
          f"path; its exact meters launch kernel F, its fp32 Snakes kernel G)")
    return launches, res


# ---------------------------------------------------------------------------
# host I/O and codecs
# ---------------------------------------------------------------------------


def _io_availability():
    """{name: present} for the system codec libraries, libav and ffmpeg."""
    from audiotools_tpu_torch import native
    from audiotools_tpu_torch.core.ffmpeg import ffmpeg_available
    from audiotools_tpu_torch.io import codecs

    return {"mp3": codecs.mp3_available(), "vorbis": codecs.vorbis_available(),
            "vorbis-encode": codecs.vorbis_encode_available(), "gsm": codecs.gsm_available(),
            "av": native.av_available(), "ffmpeg binary": ffmpeg_available()}


def _format_present(suffix, have):
    return {".mp3": have["mp3"], ".ogg": have["vorbis"] and have["vorbis-encode"],
            ".m4a": have["av"]}.get(suffix, True)


def _preset_present(preset, have):
    return {"MP3": have["mp3"], "Vorbis": have["vorbis"] and have["vorbis-encode"],
            "Ogg": have["vorbis"] and have["vorbis-encode"], "GSM-FR": have["gsm"]}.get(preset,
                                                                                      True)


def _quantized(x, subtype):
    """What a lossless file of ``subtype`` holds for float32 ``x``."""
    if subtype == "FLOAT":
        return x
    scale = float(1 << (23 if subtype == "PCM_24" else 15))
    return (np.clip(np.rint(x.astype(np.float64) * scale), -scale, scale - 1) / scale).astype(
        np.float32)


def _sig_err(a, b):
    return float((a.audio_data.cpu() - b.audio_data.cpu()).abs().max())


def phase_host_io(root, dev, card):
    """The port's host layers on the card: the native libraries' build, the
    codec libraries present, a fixture tree in every format loaded through
    AudioDataset -> DataLoader onto the card, every apply_codec preset on the
    staged batch (card against CPU), and the ffmpeg mixin's native routes.
    Launch counts are set to 0 just before and read just after (this path
    runs none of the TPU kernels' ports; its exact meters launch kernel F)."""
    from concurrent.futures import ThreadPoolExecutor

    from audiotools_tpu_torch import AudioSignal, _build, native
    from audiotools_tpu_torch import io as pio
    from audiotools_tpu_torch.data import DataLoader
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader
    from audiotools_tpu_torch.io import amrnb, codecs
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    HK.reset_launch_counts()
    t_phase = time.perf_counter()
    res = {"formats": {}, "presets": {}, "absent": []}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:  # one g++ each, all started together
        list(pool.map(lambda f: f(), (native.get_library, native.get_flac_library,
                                      native.av_available)))
    built = {name: (f"{_build.BUILD_SECONDS[name]:.2f} s" if name in _build.BUILD_SECONDS
                    else "cached" if _build.host_library_path(name).exists()
                    else "not built (libav absent)") for name in ("wavio", "flacio", "avio")}
    print(f"[io build] g++ at first use, all started together: {time.perf_counter() - t0:.2f} s | "
          + ", ".join(f"{name} {v}" for name, v in built.items()))
    have = _io_availability()
    print("[io availability] " + ", ".join(f"{k}: {'present' if v else 'absent'}"
                                          for k, v in have.items()))

    sources = np.stack([speech_like(500 + i, IO_SECONDS) for i in range(IO_BATCH)])[:, None]
    folders = {}
    t0 = time.perf_counter()
    for label, suffix, subtype in IO_FORMATS:
        if not _format_present(suffix, have):
            res["absent"].append(f"format {label}")
            print(f"[io fixtures] {label}: absent (no system library), not run")
            continue
        folders[label] = root / "io" / label
        folders[label].mkdir(parents=True)
        with ThreadPoolExecutor(max_workers=IO_WORKERS) as pool:
            list(pool.map(lambda i: pio.save_audio(
                folders[label] / f"clip_{i:02d}{suffix}", sources[i], SR,
                **({"subtype": subtype} if subtype else {})), range(IO_BATCH)))
    print(f"[io fixtures] {IO_BATCH} clips of {IO_SECONDS:g} s at {SR} Hz in {len(folders)} "
          f"formats: {time.perf_counter() - t0:.2f} s")

    staged = None
    for label, suffix, subtype in IO_FORMATS:
        if label not in folders:
            continue
        ds = AudioDataset(AudioLoader(sources=[str(folders[label])], ext=[suffix]),
                          sample_rate=SR, n_examples=IO_BATCH, duration=IO_SECONDS)
        t0 = time.perf_counter()
        batch = next(iter(DataLoader(ds, batch_size=IO_BATCH, num_workers=IO_WORKERS)))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        sig = batch["signal"]
        want = AudioDataset.collate([ds[i] for i in range(IO_BATCH)])["signal"]
        equal = torch.equal(sig.audio_data.cpu(), want.audio_data)
        line = (f"[io load] {label}: first batch {first_s:.3f} s, {IO_BATCH / first_s:.1f} clips/s "
                f"(host clock, {IO_WORKERS} worker threads, staged on {sig.device}); shape "
                f"{tuple(sig.shape)}; card batch == CPU decode bit for bit: {equal}")
        expect(sig.device.type == "cuda", f"io {label}: the batch is on {sig.device}")
        expect(equal, f"io {label}: the card's batch differs from the CPU's decode")
        expect(sig.signal_length == int(IO_SECONDS * SR), f"io {label}: length {sig.shape}")
        if subtype is not None:  # lossless: the quantization of the source
            idx = [int(Path(p).stem.split("_")[1]) for p in batch["path"]]
            lossless = _quantized(sources[idx], subtype)
            same = np.array_equal(sig.audio_data.cpu().numpy(), lossless)
            line += f"; equals the source's {subtype} quantization: {same}"
            expect(same, f"io {label}: not the {subtype} quantization of the source")
            if label == "wav_pcm16":
                staged = sig
        print(line)
        res["formats"][label] = {"first_batch_s": first_s, "clips_per_s": IO_BATCH / first_s}

    wavs = sorted(folders["wav_pcm16"].glob("*.wav"))
    t0 = time.perf_counter()
    batch_out, _ = native.read_batch(wavs, [0.0] * len(wavs), [IO_SECONDS] * len(wavs))
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = [native.read_wav(p)[0] for p in wavs]
    single_s = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(batch_out, single))
    print(f"[io read_batch] {len(wavs)} WAVs of {IO_SECONDS:g} s: native.read_batch {batch_s * 1e3:.2f} ms, "
          f"per-file read_wav {single_s * 1e3:.2f} ms ({single_s / batch_s:.2f}x; host clock); "
          f"equal: {same}")
    expect(same, "io: read_batch differs from per-file read_wav")
    res["read_batch_ms"], res["read_wav_ms"] = batch_s * 1e3, single_s * 1e3

    host_x = staged.audio_data.cpu().numpy()
    for preset in IO_PRESETS:
        if not _preset_present(preset, have):
            res["absent"].append(f"preset {preset}")
            print(f"[io preset] {preset}: absent (no system library), not run")
            continue
        sig = staged.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sig.apply_codec(preset)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        expect(out.device.type == "cuda", f"io {preset}: output on {out.device}")
        expect(out.shape == staged.shape, f"io {preset}: shape {out.shape}")
        cpu = AudioSignal(host_x, SR, device="cpu")
        line = f"[io preset] {preset}: {ms:.1f} ms a batch of {IO_BATCH} x {IO_SECONDS:g} s (host clock)"
        if preset == "8-bit":
            device_ms = time_ms(lambda: staged.clone().apply_codec(preset), N_ITER)
            diff = (out.audio_data.cpu() - cpu.apply_codec(preset).audio_data).abs()
            share = float((diff > ZOO_ABS).float().mean())
            line += (f"; device (all of it) {device_ms:.3f} ms (CUDA events); card vs CPU: share "
                     f"of samples off by more than {ZOO_ABS:g}: {share:.2e} (tol {ZOO_SHARE:g})")
            expect(share <= ZOO_SHARE, f"io 8-bit: card vs CPU share {share:.2e}")
        elif preset in ("MP3", "Vorbis", "Ogg"):
            equal = torch.equal(out.audio_data.cpu(), cpu.apply_codec(preset).audio_data)
            device_ms = 0.0
            line += f"; device: none (one copy each way); card == CPU bit for bit: {equal}"
            expect(equal, f"io {preset}: the card's result differs from the CPU's")
        else:
            down = staged.clone().resample(8000)
            down_err = _sig_err(down, AudioSignal(host_x, SR, device="cpu").resample(8000))
            host8 = down.audio_data.cpu().numpy()
            t0 = time.perf_counter()
            coded = (amrnb.amrnb_roundtrip_batch(host8) if preset == "Amr-nb"
                     else np.stack([codecs.gsm_roundtrip(item) for item in host8]))
            codec_s = time.perf_counter() - t0
            coded = torch.from_numpy(np.asarray(coded, np.float32))
            up = AudioSignal(coded.to(dev), 8000).resample(SR)
            up.zero_pad(0, max(0, staged.signal_length - up.signal_length))
            up.truncate_samples(staged.signal_length)
            cpu_up = AudioSignal(coded.numpy(), 8000, device="cpu").resample(SR)
            cpu_up.zero_pad(0, max(0, staged.signal_length - cpu_up.signal_length))
            cpu_up.truncate_samples(staged.signal_length)
            up_err = _sig_err(up, cpu_up)
            same = torch.equal(out.audio_data, up.audio_data)
            down_ms = time_ms(lambda: staged.clone().resample(8000), N_ITER)
            up_ms = time_ms(lambda: AudioSignal(coded.to(dev), 8000).resample(SR), N_ITER)
            device_ms = down_ms + up_ms
            line += (f"; device (the resamples) {down_ms:.3f} + {up_ms:.3f} ms (CUDA events); host "
                     f"codec {codec_s * 1e3:.1f} ms; card vs CPU: 8 kHz resample {down_err:.2e}, "
                     f"resample back {up_err:.2e} (tol {IO_TOL['resample_abs']:g}); the codec "
                     f"fed the card's 8 kHz audio == the preset on the card: {same}")
            expect(down_err <= IO_TOL["resample_abs"], f"io {preset}: 8 kHz resample {down_err:.2e}")
            expect(up_err <= IO_TOL["resample_abs"], f"io {preset}: resample back {up_err:.2e}")
            expect(same, f"io {preset}: the preset differs from its stages")
        print(line + f" | {card}")
        res["presets"][preset] = {"ms": ms, "device_ms": device_ms}

    checked = staged[list(range(N_CHECK))]
    lufs = checked.clone().ffmpeg_loudness()
    route = "ffmpeg binary" if have["ffmpeg binary"] else "native (BS.1770 meter on the card)"
    file_lufs, file_gap = [], 0.0
    for i in range(N_CHECK):
        checked[i].write(root / "io" / f"meter_{i}.wav")
        file_lufs.append(float(AudioSignal(root / "io" / f"meter_{i}.wav").loudness()[0]))
    file_gap = max(abs(float(lufs[i]) - file_lufs[i]) for i in range(N_CHECK))
    mem_gap = float((lufs - checked.clone().loudness()).abs().max())
    tol = IO_TOL["lufs_file_db"] if have["ffmpeg binary"] else IO_TOL["lufs_db"]
    print(f"[io ffmpeg] route: {route}; ffmpeg_loudness on {lufs.device}: "
          f"{[round(float(v), 4) for v in lufs]} LUFS; against loudness() of the 16-bit file "
          f"{file_gap:.2e} dB (tol {tol:g}), of the signal {mem_gap:.3f} dB "
          f"(tol {IO_TOL['lufs_file_db']:g})")
    expect(lufs.device.type == "cuda", f"io: ffmpeg_loudness on {lufs.device}")
    expect(file_gap <= tol, f"io: ffmpeg_loudness vs the file's loudness {file_gap:.2e}")
    expect(mem_gap <= IO_TOL["lufs_file_db"], f"io: ffmpeg_loudness vs loudness {mem_gap:.3f}")
    resampled = checked.clone().ffmpeg_resample(16000)
    direct = checked.clone().resample(16000)
    rs_err = _sig_err(resampled, direct)
    rs_tol = 1e-2 if have["ffmpeg binary"] else 0.0
    print(f"[io ffmpeg] ffmpeg_resample(16000) on {resampled.device} against resample: {rs_err:.2e}"
          f" (tol {rs_tol:g})")
    expect(resampled.device.type == "cuda" and rs_err <= rs_tol, f"io: ffmpeg_resample {rs_err:.2e}")
    flac = sorted(folders["flac16"].glob("*.flac"))[0]
    via = AudioSignal.load_from_file_with_ffmpeg(flac)
    plain = AudioSignal(flac)
    same = via.device.type == "cuda" and torch.equal(via.audio_data, plain.audio_data)
    print(f"[io ffmpeg] load_from_file_with_ffmpeg({flac.name}) on {via.device} == AudioSignal(path): "
          f"{same}")
    expect(same, "io: load_from_file_with_ffmpeg differs from AudioSignal(path)")

    one = staged[0]
    for label, suffix, subtype in IO_FORMATS:
        if label not in folders:
            continue
        path = root / "io" / f"written_{label}{suffix}"
        one.write(path, **({"subtype": subtype} if subtype else {}))
        back = AudioSignal(path)
        data, _ = pio.load_audio(path)
        bits = (back.sample_rate == SR and bool(torch.isfinite(back.audio_data).all())
                and torch.equal(back.audio_data[0].cpu(), torch.from_numpy(data)))
        if subtype is not None:
            bits = bits and np.array_equal(data, _quantized(host_x[0], subtype))
        print(f"[io write] {label}: written from the card and read back onto {back.device}, "
              f"{back.signal_length} samples: {'as decoded on the host' if bits else 'MISMATCH'}"
              + (f", the source's {subtype} quantization" if subtype and bits else ""))
        expect(back.device.type == "cuda", f"io write {label}: read back onto {back.device}")
        expect(bits, f"io write {label}: does not read back")

    launches = dict(HK.LAUNCHES)
    print(f"[io] absent here: {res['absent'] or 'nothing'} | phase {time.perf_counter() - t_phase:.1f} s "
          f"| {card}")
    print(f"[launches] host I/O and codecs: {launches} (none of the TPU kernels' ports lies on "
          f"this path; the meters launch kernel F)")
    expect(launches["iir_block_scan"] > 0 and not any(
        v for k, v in launches.items() if k != "iir_block_scan"), f"io: kernels launched {launches}")
    return launches, res


def long_signal(seconds, seed, dev):
    """``(1, 2, seconds * SR)`` stereo made on ``dev`` from ``seed``: noise
    under a slow loudness swell, with a quiet stretch so that both gates of
    the meter engage."""
    g = torch.Generator(device=dev).manual_seed(seed)
    T = int(seconds * SR)
    x = torch.randn(1, 2, T, generator=g, device=dev)
    env = 0.05 * (1.2 + torch.sin(torch.arange(T, device=dev) * (2 * np.pi / (97 * SR))))
    env[T // 3: T // 3 + T // 10] *= 1e-2
    return x.mul_(env)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_long_signal(root, dev, card):
    """The long-signal (sequence-parallel) path at world size 1 under nccl:
    one hour of stereo through each sharded op, timed (CUDA events, the
    second of two runs) with its peak memory, and held to its single-device
    op on the card; the meter also to the FIR meter of
    ``set_fast_meter(True)`` (kernel C). Launch counts are set to 0 just
    before the sharded ops and read just after (none of the five kernels
    lies on this path); kernel C's launches by the comparison meter are
    read apart."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops import resample as PRS
    from audiotools_tpu_torch.ops.filters import causal_fft_conv1d
    from audiotools_tpu_torch.parallel import (make_mesh, sharded_fir_conv, sharded_istft,
                                               sharded_loudness, sharded_resample, sharded_stft)

    res = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_mesh({"sp": 1})
        full = long_signal(LONG_SECONDS, 15, dev)
        print(f"[long] input {tuple(full.shape)} fp32 ({full.numel() * 4 / 1e9:.3f} GB) on "
              f"{full.device}, mesh {mesh} over nccl | {card}")
        x = DTensor.from_local(full, mesh, [Shard(2)])
        # one channel, cut to whole hops
        T1 = full.shape[-1] // LONG_HOP * LONG_HOP
        mono = full[:, 0, :T1].contiguous()
        h = torch.from_numpy(PL._exact_fir(SR, "K-weighting")).to(dev)
        state = {}

        def stft():
            state["spec"], state["n_valid"] = sharded_stft(
                DTensor.from_local(mono, mesh, [Shard(1)]), LONG_WINDOW, LONG_HOP, mesh)
            return state["spec"]

        ops = {  # name: (sharded, single-device, tolerance)
            "fir": (lambda: sharded_fir_conv(x, h, mesh), lambda: causal_fft_conv1d(full, h),
                    "fir_abs"),
            "stft": (stft, lambda: PF.stft(mono, LONG_WINDOW, LONG_HOP), "stft_rel"),
            "istft": (lambda: sharded_istft(state["spec"], LONG_WINDOW, LONG_HOP, mesh,
                                            n_valid=state["n_valid"]),
                      lambda: PF.istft(PF.stft(mono, LONG_WINDOW, LONG_HOP), LONG_WINDOW,
                                       LONG_HOP, length=T1), "istft_abs"),
            "resample": (lambda: sharded_resample(x, SR, LONG_RATE, mesh),
                         lambda: PRS.resample(full, SR, LONG_RATE), "resample_abs"),
            "loudness": (lambda: sharded_loudness(x, SR, mesh),
                         lambda: PL.loudness(full, SR, use_fir=False), "lufs_exact_db"),
        }
        results = {}
        HK.reset_launch_counts()
        for name, (sharded, _, _) in ops.items():
            for _ in range(2):  # the first builds FFT plans and designs
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                got = sharded()
                end.record()
                end.synchronize()
            results[name] = (got.to_local(), start.elapsed_time(end),
                             torch.cuda.max_memory_allocated() - base)
        launches = dict(HK.LAUNCHES)
        for name, (_, local, tol) in ops.items():
            got, ms, peak = results[name]
            want = local()
            if name == "stft":  # the valid frames, against the spectrum's scale
                err = float((got[..., :want.shape[-1]] - want).abs().max() / want.abs().max())
            else:
                err = float((got - want).abs().max())
            res[name] = {"ms": ms, "peak": peak, "err": err}
            print(f"[long] {name}: {ms:.3f} ms (CUDA events), peak +{peak / 2**30:.3f} GiB "
                  f"over the inputs | against the single-device op {err:.3g} (bound "
                  f"{LONG_TOL[tol]:g}) | {card}")
            expect(err <= LONG_TOL[tol], f"long signal {name}: {err} against the local op")
            del want
        trip = float((results["istft"][0] - mono).abs().max())
        print(f"[long] STFT round trip against the signal: {trip:.3g} (bound "
              f"{LONG_TOL['round_trip_abs']:g})")
        expect(trip <= LONG_TOL["round_trip_abs"], f"long signal: round trip {trip}")
        lufs = results["loudness"][0]
        HK.reset_launch_counts()
        with meter(True):  # set_fast_meter(True): the FIR meter through kernel C
            fir_meter = PL.loudness(full, SR)
        torch.cuda.synchronize()
        meter_launches = dict(HK.LAUNCHES)
        gap = float((lufs - fir_meter).abs().max())
        print(f"[long] loudness {lufs.tolist()} LUFS; the FIR meter (kernel C, "
              f"{meter_launches['fir_causal']} launch) {fir_meter.tolist()}: {gap:.3g} "
              f"(bound {LONG_TOL['lufs_fir_meter_db']:g})")
        expect(gap <= LONG_TOL["lufs_fir_meter_db"], f"long signal: FIR meter gap {gap}")
        expect(meter_launches["fir_causal"] > 0, "long signal: the FIR meter did not launch C")
        try:
            sharded_stft(DTensor.from_local(mono[:, :8192].contiguous(), mesh, [Shard(1)]),
                         LONG_WINDOW, LONG_HOP // 2, mesh)
            refused = None
        except ValueError as e:
            refused = str(e)
        print(f"[long] {LONG_WINDOW}/{LONG_HOP // 2} on one shard: "
              f"{'refused (' + refused + ')' if refused else 'NOT refused'}")
        expect(refused is not None and "narrow" in refused,
               "long signal: one shard took a hop below half the window")
        del results, x, full, mono, state
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"[launches] long signal: {launches} (none of the five kernels lies on this path); "
          f"its comparison meter: {meter_launches}")
    expect(not any(launches.values()), f"long signal: kernels launched {launches}")
    return launches, res


def phase_codec_example(root):
    """``examples/codec.py --toy`` compress and decompress on the card.
    Launch counts are set to 0 just before and read just after (the DAC's
    Snakes launch kernel G; no other kernel lies on this path)."""
    from audiotools_tpu_torch.examples import codec
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    HK.reset_launch_counts()
    src = root / "spk" / "spk_0.wav"
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        art_path, out_path = Path(tmp) / "clip.dacz.npz", Path(tmp) / "out.wav"
        t0 = time.perf_counter()
        art = codec.main(["compress", str(src), str(art_path), "--toy"])
        t1 = time.perf_counter()
        recon = codec.main(["decompress", str(art_path), str(out_path), "--toy"])
        t2 = time.perf_counter()
        from audiotools_tpu_torch.io import read_wav

        data, sr = read_wav(out_path)
    n_src = read_wav(src)[0].shape[-1]
    ok = (recon.device.type == "cuda" and sr == SR and data.shape[-1] == n_src
          and bool(np.isfinite(data).all()) and art["codes"].shape[1] == 4)
    print(f"[codec example] --toy on the card: compress {t1 - t0:.3f} s -> codes "
          f"{art['codes'].shape}, decompress {t2 - t1:.3f} s -> {data.shape[-1]} samples at "
          f"{sr} Hz on {recon.device} (host clock, with file I/O): {'ok' if ok else 'WRONG'}")
    expect(ok, "codec example: compress/decompress on the card")
    launches = dict(HK.LAUNCHES)
    print(f"[launches] codec example: {launches} (kernel G, the DAC's Snakes, alone)")
    expect(launches["snake"] > 0 and not any(v for k, v in launches.items() if k != "snake"),
           f"codec example: kernels launched {launches}")
    return launches


def _sharded_models(label, dev, mesh, seed=0):
    """Phase 8's fresh seeded models on ``dev`` placed on ``mesh``
    (``shard_params``), their optimizers, and the step of ``label``."""
    from audiotools_tpu_torch.models import DAC, Discriminator
    from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step
    from audiotools_tpu_torch.models.train import make_train_step, shard_params

    gen = shard_params(DAC(seed=seed).to(dev), mesh)
    if label == "reconstruction":
        opt = _adamw(gen)
        return {"g": gen}, {"g": opt}, make_train_step(gen, opt, SR)
    disc = shard_params(Discriminator(seed=seed + 1).to(dev), mesh)
    opts = {"g": _adamw(gen), "d": _adamw(disc)}
    return ({"g": gen, "d": disc}, opts,
            make_adversarial_train_step(gen, disc, opts["g"], opts["d"], SR))


def _optimizer_ms(opt):
    """Host milliseconds of one ``opt.step()`` on the gradients it holds,
    the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000


def _placements_kept(got, want):
    """Every parameter of ``got`` a DTensor placed as ``want``'s is."""
    return all(type(a).__name__ == "DTensor" and a.placements == b.placements
               for a, b in zip(got.parameters(), want.parameters()))


def phase_model_parallel(root, dev, card, audio, unsharded):
    """Model-parallel training at world size 1 under nccl: phase 8's models,
    weights and batch through ``shard_params`` on a ``{"dp": 1, "tp": 1}``
    mesh, each step TRAIN_STEPS times (the first untimed) beside phase 8's
    ``unsharded`` results; one step of each against the unsharded step
    inside ``strict_fp32``; the sharded state through ``Checkpointer`` and
    back. Launch counts are set to 0 just before the timed steps and read
    just after (kernel G, the DAC's Snakes, alone lies on this path)."""
    import torch.distributed as dist

    from audiotools_tpu_torch.ml.checkpoint import Checkpointer
    from audiotools_tpu_torch.models import DAC
    from audiotools_tpu_torch.models.train import make_train_step
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops._fp32 import strict_fp32
    from audiotools_tpu_torch.parallel import make_mesh
    from audiotools_tpu_torch.parallel import tensor as PTT

    res, launches = {}, {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_mesh({"dp": 1, "tp": 1})
        for label in ("reconstruction", "adversarial"):
            models, opts, step = _sharded_models(label, dev, mesh)
            placed = {k: sum(any(p.is_shard() for p in q.placements) for q in m.parameters())
                      for k, m in models.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            HK.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = step(audio)  # untimed
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(TRAIN_STEPS - 1):
                metrics = step(audio)
            end.record()
            end.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000 / (TRAIN_STEPS - 1)
            ms = start.elapsed_time(end) / (TRAIN_STEPS - 1)
            launches[label] = dict(HK.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            prof_wall, busy, n_kernels, rows = profile_step(step, audio, top=5)
            values = {k: float(v) for k, v in metrics.items()}
            hooks = sum(len(PTT.placement(m).handles) for m in models.values())
            base = unsharded[label]
            print(f"[model parallel {label}] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                  f"over nccl, weights placed Shard on tp: {placed}, data-axis hooks: {hooks}, "
                  f"{TRAIN_BATCH} x {TRAIN_SAMPLES}: {ms:.3f} ms/step (CUDA events, "
                  f"{TRAIN_STEPS - 1} steps after one untimed of {first_s:.2f} s; host wall "
                  f"{wall_ms:.3f} ms) | {TRAIN_BATCH / ms * 1000:.2f} clips/s | peak "
                  f"{peak / 2**30:.3f} GiB | phase 8 unsharded: {base['ms']:.3f} ms/step "
                  f"({ms / base['ms']:.3f}x), {TRAIN_BATCH / base['ms'] * 1000:.2f} clips/s, "
                  f"peak {base['peak'] / 2**30:.3f} GiB | {card}")
            print(f"[model parallel {label}] metrics: "
                  + ", ".join(f"{k} {v:.5g}" for k, v in values.items())
                  + f" | kernel launches: {launches[label]}")
            if busy > 0:
                print(f"[model parallel {label}] profiled step (wall {prof_wall:.3f} ms): "
                      f"{n_kernels} kernels, {busy:.3f} ms a step, device idle "
                      f"{1 - busy / ms:.1%} of the unprofiled {ms:.3f} ms; by device time: "
                      + "; ".join(f"{name} {t:.3f} ms x{n}" for name, t, n in rows))
            else:
                print(f"[model parallel {label}] profiled step: the profiler recorded no "
                      f"device time")
            expect(all(np.isfinite(v) for v in values.values()),
                   f"model parallel {label}: non-finite {values}")
            expect(hooks == 0, f"model parallel {label}: {hooks} hooks at one data rank")
            res[label] = dict(ms=ms, wall_ms=wall_ms, peak=peak, first_s=first_s, busy_ms=busy)
            if label == "reconstruction":  # the optimizer's share of the host's time
                plain = DAC(seed=0).to(dev)
                plain_opt = _adamw(plain)
                make_train_step(plain, plain_opt, SR)(audio)
                opt_ms = {"sharded": _optimizer_ms(opts["g"]), "unsharded": _optimizer_ms(plain_opt)}
                print(f"[model parallel {label}] one more AdamW step alone, on the last step's "
                      f"gradients (host clock, synchronized): sharded {opt_ms['sharded']:.3f} ms, "
                      f"unsharded {opt_ms['unsharded']:.3f} ms")
                res["optimizer_ms"] = opt_ms
                del plain, plain_opt
            del models, opts, step, metrics
            torch.cuda.empty_cache()

        with strict_fp32():
            for label in ("reconstruction", "adversarial"):
                models, opts, step = _sharded_models(label, dev, mesh)
                plain, plain_step = _training_step(label, dev)
                m_sh = {k: float(v) for k, v in step(audio).items()}
                m_pl = {k: float(v) for k, v in plain_step(audio).items()}
                loss_rel = max(abs(m_sh[k] - m_pl[k]) / abs(m_pl[k]) for k in m_pl)
                worst, share = _max_update_gap(list(models.values()), plain)
                print(f"[model parallel card check] {label}, strict fp32, sharded against "
                      f"unsharded from the same weights: loss_rel {loss_rel:.3e} (tol "
                      f"{TRAIN_TOL['loss_rel']:g}) | after the step: largest parameter gap "
                      f"{worst / LR:.3f} LR (tol 2), share over {TRAIN_TOL['update_lr']:g} LR "
                      f"{share:.2e} (tol {TRAIN_TOL['update_share']:g}) | loss sharded "
                      f"{m_sh['loss']:.6f}, unsharded {m_pl['loss']:.6f}")
                expect(loss_rel <= TRAIN_TOL["loss_rel"],
                       f"model parallel {label}: losses against the unsharded step {loss_rel}")
                expect(worst <= 2.01 * LR and share <= TRAIN_TOL["update_share"],
                       f"model parallel {label}: parameters after the step differ "
                       f"({worst / LR:.3f} LR, share {share:.2e})")
                del plain, plain_step
                if label == "adversarial":
                    saved = {"params": {k: _host_tree(m.state_dict()) for k, m in models.items()},
                             "opt_state": {k: _host_tree(o.state_dict())
                                           for k, o in opts.items()}}
                    with tempfile.TemporaryDirectory(dir=root) as tmp:
                        ck = Checkpointer(tmp)
                        t0 = time.perf_counter()
                        folder = ck.save(1, models, opts)
                        save_s = time.perf_counter() - t0
                        size = sum(f.stat().st_size for f in folder.iterdir())
                        fresh, fresh_opts, _ = _sharded_models(label, dev, mesh, seed=5)
                        t0 = time.perf_counter()
                        ck.restore(template={"params": fresh, "opt_state": fresh_opts})
                        torch.cuda.synchronize()
                        restore_s = time.perf_counter() - t0
                    got = {"params": {k: _host_tree(m.state_dict()) for k, m in fresh.items()},
                           "opt_state": {k: _host_tree(o.state_dict())
                                         for k, o in fresh_opts.items()}}
                    mismatches = _tree_mismatches(got, saved)
                    kept = all(_placements_kept(fresh[k], models[k]) for k in models)
                    print(f"[model parallel checkpoint] {size / 2**20:.1f} MiB (both nets, both "
                          f"AdamW states) saved in {save_s:.3f} s, restored into fresh sharded "
                          f"models in {restore_s:.3f} s (host clock): "
                          f"{'bit-equal' if not mismatches else f'{len(mismatches)} differ'}, "
                          f"placements {'kept' if kept else 'LOST'}")
                    expect(not mismatches, f"model parallel checkpoint: {mismatches[:5]}")
                    expect(kept, "model parallel checkpoint: placements lost")
                    res["checkpoint"] = dict(mib=size / 2**20, save_s=save_s,
                                             restore_s=restore_s)
                    del fresh, fresh_opts
                del models, opts, step
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    total = {k: sum(c[k] for c in launches.values()) for k in launches["reconstruction"]}
    print(f"[launches] model parallel: {total} (kernel G, the DAC's Snakes, alone)")
    expect(total["snake"] > 0 and total["snake_backward"] == total["snake"] and not any(
        v for k, v in total.items() if k not in ("snake", "snake_backward")),
        f"model parallel: kernels launched {total}")
    return total, res


# ---------------------------------------------------------------------------
# accounting: device timers, counted work, MFU and rooflines
# ---------------------------------------------------------------------------


def main_kernel_cases(dev):
    """Each kernel's wrapper and arguments at its main-path shape, the
    shapes of the kernel table's rows: A at the Equalizer's (64 rows of 5 s
    + 640, 641 taps), B at the pitch shift's without the track, C at the
    exact-length meter's (1023 taps), D at 65,600 x 432, E at the chain's
    synthesis (64 x 432 x 1025, hop 512), F at the exact meter's stacked
    rows (128 x 431 blocks x 4 states), G forward and backward at the codec
    decoder's last Snake (1 x 96 x 1,323,008)."""
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import loudness as PL

    rng = np.random.RandomState(9)
    n = int(SR * DURATION)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    nt, n_freq = 432, 1025
    spec = torch.from_numpy(((rng.randn(BATCH, nt, n_freq) + 1j * rng.randn(BATCH, nt, n_freq))
                             * 0.05).astype(np.complex64)).to(dev)
    (w,) = PF._on_device(PF._synthesis_design, ("hann", 2048, 512), dev)
    (env,) = PF._on_device(PF._inverse_envelope, ("hann", 2048, 512, nt), dev)
    return {
        "fir_causal_batch": (HK.fir_causal_batch, (randn(BATCH, n + 640),
                                                   randn(BATCH, 641, scale=0.05))),
        "phase_vocoder_fused": (HK.phase_vocoder_fused, pv_main_case(dev)),
        "fir_causal": (HK.fir_causal, (randn(BATCH, n, scale=0.1), torch.from_numpy(
            PL._composed_fir(SR, "K-weighting", 512)).to(dev))),
        "rotation_cumprod": (HK.rotation_cumprod, rotation_main_case(dev)),
        "istft_synthesis_fused": (HK.istft_synthesis_fused, (spec, w, 512, env)),
        "iir_block_scan": (HK.iir_block_scan, scan_main_case(dev, 2 * BATCH)),
        "snake": (HK.snake, snake_main_case(dev, SNAKE_SHAPES["codec"])[:2]),
        "snake_backward": (HK.snake_backward, snake_main_case(dev, SNAKE_SHAPES["codec"])),
    }


def other_kernel_cases(dev):
    """The kernel table's other rows, by label: A at the multitrack EQs'
    shapes (64 rows of 5 s / 1.25 and 5 s / 0.8, + 640; 641 taps), B at the
    multitrack stretches' (64 x 1 x 1025 bins, 431 frames -> 345 / 539
    steps), and B with its phasor track at the pitch shift's shape (the
    differentiable vocoder's forward)."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import stretch as PS

    rng = np.random.RandomState(10)
    n = int(SR * DURATION)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    tm = (BATCH, 1, 1 + n // 512, 1025)
    z = torch.from_numpy((rng.randn(*tm) + 1j * rng.randn(*tm)).astype(np.complex64)).to(
        dev).transpose(-1, -2)
    cases = {}
    for factor in MT_FACTORS:
        cases[f"fir_causal_batch multitrack {factor:g}"] = (
            "fir_causal_batch", HK.fir_causal_batch,
            (randn(BATCH, int(n / factor) + 640), randn(BATCH, 641, scale=0.05)))
        cases[f"phase_vocoder_fused multitrack {factor:g}"] = (
            "phase_vocoder_fused", HK.phase_vocoder_fused, (z, *PS._pv_indices(tm[2], factor)))
    cases["phase_vocoder_fused with_phasor"] = (
        "phase_vocoder_fused", HK.phase_vocoder_fused, (*pv_main_case(dev), True))
    return cases


def _account_kernel(label, name, wrapper, args, card):
    """One kernel call timed by ``time_ms``, ``device_time`` and
    ``device_time_stats``, and its ``xla_cost`` (the kernel launched once)
    held to its registered work."""
    from audiotools_tpu_torch.ops import benchmark as BM
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    def call(a):
        return wrapper(*a)

    before = HK.LAUNCHES[name]
    cost = PERF.xla_cost(wrapper, *args)
    torch.cuda.synchronize()
    launched = HK.LAUNCHES[name] - before
    work = wrapper.work(*args)
    ms = time_ms(lambda: call(args), ACCT_KERNEL_ITERS)
    seconds = BM.device_time(call, args, iters=ACCT_KERNEL_ITERS)
    st = BM.device_time_stats(call, args, iters=ACCT_KERNEL_ITERS, repeats=ACCT_KERNEL_REPEATS)
    print(f"[accounting kernel] {label} ({_shapes(args)}): time_ms {ms:.4f} | device_time "
          f"{seconds * 1e3:.4f} ms | device_time_stats {st['seconds'] * 1e3:.4f} ms (min "
          f"{st['min'] * 1e3:.4f}, max {st['max'] * 1e3:.4f}, spread {st['spread']}) | "
          f"xla_cost {cost['flops']:.6g} flops, {cost['bytes']:.6g} bytes; registered work "
          f"{work['flops']:.6g}, {work['bytes']:.6g}; kernel launches under xla_cost "
          f"{launched} | {card}")
    expect(cost == work, f"{label}: xla_cost {cost} is not its registered work {work}")
    expect(launched == 1, f"{label}: xla_cost launched the kernel {launched} times, not once")
    expect(seconds > 1e-9 and st["min"] > 1e-9, f"{label}: device_time at its floor")
    return dict(ms=ms, device_ms=seconds * 1e3, stats=st, cost=cost)


def _shapes(args):
    return ", ".join(str(tuple(a.shape)) if torch.is_tensor(a) else
                     (f"{len(a)} steps" if isinstance(a, np.ndarray) else repr(a)) for a in args)


def phase_accounting(dev, card, ds, batch, train_audio, ds_original_phase):
    """The port's performance accounting on the card (``ops.perf``,
    ``ops.benchmark``): each kernel at its main-path shape timed by
    ``device_time`` and ``device_time_stats`` beside ``time_ms``, its
    counted work (``xla_cost`` of the wrapper, the kernel launched) equal to
    its registered work, and so at the kernel table's other shapes
    (``other_kernel_cases``); the two training steps timed as ``bench.py`` times
    the JAX ones, with ``mfu`` from the analytic counters and ``mfu_xla`` /
    ``hbm_frac`` from one step's ``xla_cost``, its FLOPs within
    ``ACCT_FLOP_BAND`` of the analytic core; a ``stage_roofline`` row for each
    stage of the main chain and the chain's ``summarize``; rows for the
    original-phase path's transforms stage (``ds_original_phase``) and for
    the reverb alone in both configurations, on the same batch (the two
    datasets draw the same arguments). Launch counts are set to 0 just before and read
    just after."""
    from audiotools_tpu_torch.ops import benchmark as BM
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops import stretch as PS

    res = {"kernels": {}, "other_kernels": {}, "steps": {}, "stages": []}
    HK.reset_launch_counts()
    for name, (wrapper, args) in main_kernel_cases(dev).items():
        res["kernels"][name] = _account_kernel(name, name, wrapper, args, card)
    for label, (name, wrapper, args) in other_kernel_cases(dev).items():
        res["other_kernels"][label] = _account_kernel(label, name, wrapper, args, card)

    for label, analytic in (
        ("reconstruction", PERF.dac_train_step_flops(TRAIN_BATCH, TRAIN_SAMPLES)),
        ("adversarial", PERF.adversarial_train_step_flops(TRAIN_BATCH, TRAIN_SAMPLES)),
    ):
        models, step = _training_step(label, dev)
        step(train_audio)  # untimed: cuDNN's algorithm search
        if label == "reconstruction":
            st = BM.device_time_stats(step, train_audio, iters=ACCT_STEP_ITERS,
                                      repeats=ACCT_STEP_REPEATS)
            seconds, timer = st["seconds"], (f"device_time_stats median of {ACCT_STEP_REPEATS} "
                                             f"(spread {st['spread']})")
        else:
            # the fetch of the last step's loss queues after both updates
            seconds = BM.device_time_queued(step, train_audio, iters=ACCT_STEP_ITERS,
                                            sync=lambda out: out["loss"])
            timer = "device_time_queued"
        cost = PERF.xla_cost(step, train_audio)
        summary = PERF.summarize(label, seconds, analytic, cost)
        ratio = cost["flops"] / analytic
        print(f"[accounting step] {label} {TRAIN_BATCH} x {TRAIN_SAMPLES}: {seconds * 1e3:.3f} "
              f"ms/step ({timer}) | analytic {analytic:.6g} FLOP, mfu "
              f"{PERF.mfu(analytic, seconds):.6f} | xla_cost {cost['flops']:.6g} FLOP "
              f"({ratio:.4f}x the analytic core), {cost['bytes']:.6g} bytes, mfu_xla "
              f"{PERF.mfu(cost['flops'], seconds):.6f}, hbm_frac "
              f"{PERF.hbm_roofline_frac(cost['bytes'], seconds):.6f} | summarize "
              f"{json.dumps(summary)} | {card}")
        expect(ACCT_FLOP_BAND[0] <= ratio <= ACCT_FLOP_BAND[1],
               f"{label}: counted FLOPs {ratio:.4f}x the analytic core, outside {ACCT_FLOP_BAND}")
        expect(set(summary) == {"mfu", "mfu_xla", "hbm_frac"}, f"{label}: summary {summary}")
        res["steps"][label] = dict(seconds=seconds, analytic=analytic, cost=cost, **summary)
        del models, step

    with meter(False):
        audio = ds.transform(batch["signal"].clone(), **batch["transform_args"]).audio_data
        shifted = PS.pitch_shift(audio, 2.0, SR, synthesis_method="matmul_bf16",
                                 pv_formulation="phasor_fused")
        def transforms(d):
            return lambda b: d.transform(b["signal"].clone(), **b["transform_args"])

        def reverb(d):
            rir = next(iter(d.transform))  # RoomImpulseResponse, as Compose calls it
            return lambda b: rir(b["signal"].clone(), **b["transform_args"]["Compose"])

        for name, fn, arg in (
            ("transforms", transforms(ds), batch),
            ("pitch_shift", lambda a: PS.pitch_shift(a, 2.0, SR, synthesis_method="matmul_bf16",
                                                     pv_formulation="phasor_fused"), audio),
            ("mel", lambda a: PF.mel_spectrogram(a, SR, 80, method="matmul"), shifted),
            ("loudness", lambda a: PL.loudness(a, SR), shifted),
            ("transforms original_phase", transforms(ds_original_phase), batch),
            ("reverb", reverb(ds), batch),
            ("reverb original_phase", reverb(ds_original_phase), batch),
        ):
            row = PERF.stage_roofline(name, fn, arg, iters=N_ITER)
            print(f"[accounting stage] {json.dumps(row)} | {card}")
            expect(set(row) == ROOFLINE_KEYS and row["ms"] > 0 and row["gbytes"] > 0,
                   f"stage_roofline row {row}")
            res["stages"].append(row)

        def chain(b):
            return run_chain(ds, b)

        seconds = BM.device_time(chain, batch, iters=N_ITER)
        cost = PERF.xla_cost(chain, batch)
    summary = PERF.summarize("chain", seconds, cost=cost)
    print(f"[accounting chain] main path {BATCH} x {DURATION:g} s: {seconds * 1e3:.3f} ms/batch "
          f"(device_time) | xla_cost {cost['flops']:.6g} FLOP, {cost['bytes']:.6g} bytes | "
          f"summarize {json.dumps(summary)} | {card}")
    expect("hbm_frac" in summary, f"chain summary {summary}")
    res["chain"] = dict(seconds=seconds, cost=cost, **summary)
    torch.cuda.synchronize()
    launches = dict(HK.LAUNCHES)
    print(f"[launches] accounting: {launches}")
    expect(all(launches[k] > 0 for k in launches), f"accounting: a kernel was not launched: "
                                                    f"{launches}")
    return launches, res


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_device()
    phase_defaults()
    a = phase_kernel_a(dev)
    b = phase_kernel_b(dev)
    c = phase_kernel_c(dev)
    d, planes = phase_kernel_d(dev)
    e, _ = phase_kernel_e(dev)
    f, _ = phase_kernel_f(dev)
    g = phase_kernel_g(dev)
    phase_ragged(dev)
    launches = {"rotation": phase_rotation(planes)}
    del planes
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        build_fixture_tree(root)
        staged = {}
        for label, original_phase, *rest in PATHS:
            if original_phase not in staged:
                staged[original_phase] = stage_batch(root, original_phase)
            launches[label] = phase_chain(*staged[original_phase], label, *rest)
        expect(torch.equal(staged[False][1]["signal"].audio_data,
                           staged[True][1]["signal"].audio_data),
               "the original-phase dataset drew other clips than the main path's")
        (ds, batch), ds_original_phase = staged[False], staged[True][0]
        phase_card_vs_cpu(ds, dev, ds_original_phase)
        del staged
        launches["pitch_grad"], _ = phase_pitch_grad(batch["signal"].audio_data)
        launches["zoo"], _ = phase_zoo(root, dev, card)
        launches["multitrack"], _ = phase_multitrack(root, dev, card)
        train_audio, train_launches, train_results = phase_codec_training(root, dev, card)
        launches.update(train_launches)
        phase_training_card_vs_cpu(train_audio, dev)
        bf16_launches, _ = phase_bf16_analysis(dev, card, batch["signal"].audio_data,
                                               train_audio, train_results["adversarial"])
        launches.update({f"bf16 {k}": v for k, v in bf16_launches.items()})
        launches["serving"], _ = phase_serving(root, dev, card)
        launches["training loop"], _ = phase_training_loop(root, dev, card)
        launches["host io"], _ = phase_host_io(root, dev, card)
        launches["long signal"], _ = phase_long_signal(root, dev, card)
        launches["codec example"] = phase_codec_example(root)
        launches["model parallel"], _ = phase_model_parallel(root, dev, card, train_audio,
                                                             train_results)
        launches["accounting"], acct = phase_accounting(dev, card, ds, batch, train_audio,
                                                        ds_original_phase)
        del train_audio, batch
    print("[launches] kernel launches by path (training: all steps of the path): " + json.dumps(
        {path: {k: v for k, v in counts.items() if v} for path, counts in launches.items()}))
    if FAILED:
        fail(f"{len(FAILED)} failed checks: {FAILED}")

    def row(name, source, replaces, paths, results, key=None):
        """``results``: {shape label: measurements}, reported at ``key``, or
        the measurements of one shape; ``launches`` summed over ``paths``;
        ``replaces``: a line of ``pallas_kernels.py``, or the file and line of
        what else the kernel replaces."""
        if key is None:
            results, key = {key: results}, key
        at = results[key]
        if isinstance(replaces, int):
            replaces = f"ops/pallas_kernels.py:{replaces}"
        return {"name": name, "route": "cuda", "source": f"audiotools_tpu_torch/csrc/{source}",
                "replaces": f"audiotools_tpu/{replaces}",
                "launches": sum(launches[path][name] for path in paths.split("+")),
                "max_abs_err": max(v["abs_err"] for v in results.values()),
                **{k: at[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                                      "library", "library_ms")},
                "device_ms": acct["kernels"][name]["device_ms"]}

    kernels = [
        row("fir_causal_batch", "fir_causal_batch.cu", 182, "main+original_phase+zoo+multitrack",
            a, "equalizer"),
        row("phase_vocoder_fused", "phase_vocoder.cu", 309, "main+original_phase+multitrack", b,
            "path"),
        row("fir_causal", "fir_causal_batch.cu", 100, "parity", c, "meter"),
        # D has no caller in the library: its own path is its entry point
        row("rotation_cumprod", "rotation_cumprod.cu", 417, "rotation", d),
        row("istft_synthesis_fused", "istft_synthesis.cu", 527, "parity", e, "chain"),
        # F replaces no Pallas kernel but the JAX package's lax.scan over block states
        row("iir_block_scan", "iir_block_scan.cu", "ops/filters.py:597 (lax.scan)",
            "main+original_phase", f, "meter_stacked"),
        # G replaces no Pallas kernel but the eager Snake (XLA fuses the JAX one)
        row("snake", "snake.cu", "models/dac.py:27 (snake)", "reconstruction+adversarial", g,
            "codec"),
        row("snake_backward", "snake.cu", "models/dac.py:27 (snake)",
            "reconstruction+adversarial", g, "codec backward"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
