"""The launch plans of kernels B and D, on the CPU: the host-side arithmetic
that sizes their blocks and rings (``hopper_kernels.pv_plan``,
``rotation_plan``) from the geometry their builds take (``_build.DEFINES``),
kernel B's frame ring replayed step by step, and the wrappers that pass the
plans on. The kernels themselves run only on the card
(``test_torch_cuda.py``), where each refuses a plan that does not match its
build.
"""
import re

import numpy as np
import pytest
import torch

from audiotools_tpu_torch import _build
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import ragged_shapes as RAGGED
from audiotools_tpu_torch.ops import stretch as PS

MAIN_ROWS, MAIN_T = 64 * 1025, 384  # the pitch shift's rows and frames at +2 semitones
MAIN_STEPS = len(PS._pv_indices(MAIN_T, 2 ** (-2 / 12))[0])


def _rows(shape):
    return int(np.prod(shape[:-1], dtype=np.int64))


ROT_CASES = [(MAIN_ROWS, 432)] + [(_rows(s), s[-1]) for s in RAGGED.ROTATION] + [
    (31, 7), (32, 32), (16_896, 64), (16_897, 65), (200_000, 3)]
PV_ROWS = sorted({MAIN_ROWS, 1, 33, 511 * 132, 513 * 132}
                 | {_rows(shape) for shape, _ in RAGGED.PV})


# what one block may take on sm_90 (227 KB of shared memory, opted in), and
# what one SM shares among its blocks: 228 KB (1 KB of it reserved for each
# block) and 2048 threads
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK, THREADS_PER_SM = 233_472, 1024, 2048


def _blocks_per_sm(smem, threads):
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK), THREADS_PER_SM // threads)


def _covered_once(total, per_block, blocks):
    """Each index in [0, total) falls in exactly one block of ``per_block``."""
    seen = np.zeros(total, dtype=np.int64)
    for b in range(blocks):
        seen[b * per_block: min((b + 1) * per_block, total)] += 1
    return bool((seen == 1).all()) and (blocks - 1) * per_block < total


@pytest.mark.parametrize("source", sorted(_build.DEFINES))
def test_geometry_has_one_owner(source, monkeypatch):
    """The kernels' geometry reaches nvcc as -D flags and is not written in
    their sources: each macro is read once, into a constant, and a change
    to it rebuilds the library and changes the plan."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    before = _build.library_path(source)
    for macro, value in _build.DEFINES[source].items():
        assert f"-D{macro}={value}" in _build.flags(source)
        assert len(re.findall(rf"\b{macro}\b", text)) == 1
        assert re.search(rf"constexpr int \w+ = {macro};", text)
    plan = {"phase_vocoder": lambda: HK.pv_plan(MAIN_ROWS),
            "rotation_cumprod": lambda: HK.rotation_plan(MAIN_ROWS, 432)}[source]
    first = plan()
    macro = next(iter(_build.DEFINES[source]))
    monkeypatch.setitem(_build.DEFINES, source, {**_build.DEFINES[source], macro: 64})
    assert _build.library_path(source) != before
    assert plan() != first


# -- D: rotation_plan --------------------------------------------------------


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows,n", ROT_CASES)
def test_rotation_plan_fits_and_covers_every_row_and_step(rows, n, aligned):
    plan = HK.rotation_plan(rows, n, aligned)
    geometry = _build.DEFINES["rotation_cumprod"]
    assert (plan.rows_per_block, plan.steps, plan.stages) == (
        geometry["ROT_ROWS"], geometry["ROT_STEPS"], geometry["ROT_STAGES"])
    # 16-byte copies only where every row starts on 16 bytes
    assert plan.wide == (aligned and n % 4 == 0)
    # the ring holds its stages of two planes, each word of a tile once
    assert plan.smem >= plan.stages * 2 * plan.rows_per_block * plan.steps * 4
    assert plan.smem <= SMEM_PER_BLOCK
    assert _blocks_per_sm(plan.smem, plan.rows_per_block) >= 1
    assert _covered_once(rows, plan.rows_per_block, plan.blocks)
    assert _covered_once(n, plan.steps, -(-n // plan.steps))


def test_rotation_plan_at_the_main_shape():
    """65,600 rows x 432 steps: 128-row blocks with three 32-step stages
    copied 16 bytes at a time, two blocks to an SM (the design the kernel
    note describes); 4-byte copies take the same blocks and stages."""
    plan = HK.rotation_plan(MAIN_ROWS, 432)
    assert plan == (128, 32, 3, True, 110_592, 513)
    assert _blocks_per_sm(plan.smem, plan.rows_per_block) == 2
    narrow = HK.rotation_plan(MAIN_ROWS, 432, aligned=False)
    assert narrow == (128, 32, 3, False, 99_072, 513)
    assert _blocks_per_sm(narrow.smem, narrow.rows_per_block) == 2


# -- B: pv_plan and its ring -------------------------------------------------


@pytest.mark.parametrize("with_phasor", [False, True])
@pytest.mark.parametrize("rows", PV_ROWS)
def test_pv_plan_fits_and_covers_every_row(rows, with_phasor):
    plan = HK.pv_plan(rows, with_phasor)
    geometry = _build.DEFINES["phase_vocoder"]
    assert (plan.threads, plan.depth) == (geometry["PV_THREADS"], geometry["PV_DEPTH"])
    # depth + 1 slots of two complex64 frames for each thread
    assert plan.smem == (plan.depth + 1) * 2 * plan.threads * 8
    assert plan.smem <= SMEM_PER_BLOCK
    assert _blocks_per_sm(plan.smem, plan.threads) >= 1
    assert plan.sync_every in (0, 4) and (plan.sync_every > 0) == with_phasor
    assert _covered_once(rows, plan.threads, plan.blocks)


def test_pv_plan_at_the_main_shape():
    """512-row blocks, frames 16 steps ahead, a barrier every 4 steps only
    with the track; 129 blocks of 136 KB, one to an SM: one wave on an H100
    SXM's 132 SMs."""
    assert MAIN_STEPS == 432
    path, track = HK.pv_plan(MAIN_ROWS), HK.pv_plan(MAIN_ROWS, True)
    assert path == (512, 16, 0, 139_264, 129) and track == (512, 16, 4, 139_264, 129)
    assert _blocks_per_sm(path.smem, path.threads) == 1


def _replay_ring(i0, i1, depth):
    """Kernel B's frame ring as ``csrc/phase_vocoder.cu`` runs it: steps 0 ..
    depth - 1 fetched into slots 0 .. depth - 1 before the first step; step
    s reads slot s % (depth + 1), then fetches step s + depth into the slot
    step s - 1 read. Yields, for each step, what its slot holds (the step
    whose frames they are, the frames, the step that fetched them, -1 before
    the first) and the slot."""
    n, slots = len(i0), depth + 1
    ring = {s: (s, i0[s], i1[s], -1) for s in range(min(depth, n))}
    for s in range(n):
        slot = s % slots
        yield s, ring.pop(slot), slot
        if s + depth < n:
            into = (s - 1) % slots
            assert into not in ring  # only a slot already read is refilled
            ring[into] = (s + depth, i0[s + depth], i1[s + depth], s)
    assert not ring  # every fetched step was read


@pytest.mark.parametrize("case", range(len(RAGGED.PV) + 1))
def test_pv_ring_holds_each_steps_frames_when_it_reads_them(case):
    """At the main shape and every ragged shape, the slot a step reads holds
    that step's i0 and i1 frames, fetched ``depth`` steps earlier (or before
    the first step), and no fetch lands in a slot still waiting to be read."""
    if case == len(RAGGED.PV):
        i0, i1, _ = PS._pv_indices(MAIN_T, 2 ** (-2 / 12))
    else:
        shape, rate = RAGGED.PV[case]
        _, i0, i1, _ = RAGGED.pv_case(shape, rate, seed=case)
    depth = HK.pv_plan(MAIN_ROWS).depth
    for s, (step, a, c, fetched_at), slot in _replay_ring(i0, i1, depth):
        assert step == s and (a, c) == (i0[s], i1[s])
        assert slot == s % (depth + 1)
        assert fetched_at == -1 or fetched_at == s - depth


def test_ragged_pv_cases_hold_what_they_promise():
    """A silent bin, transient zero frames, and one table that is not
    monotone, which the kernel must take as the plain version does."""
    monotone = []
    for case, (shape, rate) in enumerate(RAGGED.PV):
        z, i0, i1, frac = RAGGED.pv_case(shape, rate, seed=case)
        assert z.shape == shape and z.dtype == np.complex64
        assert i0[0] == 0 and i0.dtype == i1.dtype == np.int32 and frac.dtype == np.float32
        assert (i0 >= 0).all() and (i1 < shape[-1]).all()
        assert (z[..., 0, 1::4] == 0).all()
        if shape[-2] > 1:
            assert (z[..., min(3, shape[-2] - 1), :] == 0).all()
        monotone.append(bool((np.diff(i0) >= 0).all() and (np.diff(i1) >= 0).all()))
    assert not all(monotone) and any(monotone)
    assert {1, 1025} <= {shape[-2] for shape, _ in RAGGED.PV}


def test_plain_vocoder_takes_a_table_that_is_not_monotone():
    """The plain version on such a table is the step formula, step by step."""
    shape, rate = next((s, r) for s, r in RAGGED.PV if r is None)
    z, i0, i1, frac = RAGGED.pv_case(shape, rate, seed=0)
    out, track = HK.phase_vocoder_fused(torch.from_numpy(z), i0, i1, frac, with_phasor=True)
    z64 = z.astype(np.complex128)
    p = np.where(np.abs(z64[..., 0]) > 0, z64[..., 0] / np.maximum(np.abs(z64[..., 0]), 1e-300), 1)
    for s in range(len(i0)):
        a0, a1 = np.abs(z64[..., i0[s]]), np.abs(z64[..., i1[s]])
        want = ((1 - frac[s]) * a0 + frac[s] * a1) * p
        assert np.abs(out.numpy()[..., s] - want).max() < 1e-4
        assert np.abs(track.numpy()[..., s] - p).max() < 1e-4
        w = z64[..., i1[s]] * np.conj(z64[..., i0[s]])
        norm = a0 * a1
        p = p * np.where(norm > 0, w / np.where(norm > 0, norm, 1), 1)


# -- the wrappers pass the plans on, and still raise -------------------------


def _capture(monkeypatch):
    calls = []
    monkeypatch.setattr(HK, "_launch", lambda name, tensors, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("with_phasor", [False, True])
def test_vocoder_wrapper_launches_with_its_plan(monkeypatch, with_phasor):
    """Off the CPU ("meta" stands in for the card) the wrapper hands the
    kernel the launch plan for its rows and steps."""
    calls = _capture(monkeypatch)
    z = torch.zeros(3, 2, 65, 40, dtype=torch.complex64, device="meta")
    i0, i1, frac = PS._pv_indices(40, 0.77)
    HK.phase_vocoder_fused(z, i0, i1, frac, with_phasor=with_phasor)
    ((name, args),) = calls
    plan = HK.pv_plan(3 * 2 * 65, with_phasor)
    assert name == "phase_vocoder_fused"
    assert args[-7:] == (6, 65, 40, len(i0), plan.sync_every, plan.smem, plan.blocks)
    assert (args[5] is None) != with_phasor  # the track's pointer only with the track


def test_rotation_wrapper_launches_with_its_plan(monkeypatch):
    calls = _capture(monkeypatch)
    ur = torch.zeros(3, 43, 33, device="meta")
    c = torch.zeros(3, 43, device="meta")
    HK.rotation_cumprod(ur, ur, c, c)
    ((name, args),) = calls
    plan = HK.rotation_plan(129, 33)
    assert name == "rotation_cumprod"
    assert not plan.wide and args[-5:] == (129, 33, 0, plan.smem, plan.blocks)
    calls.clear()
    ur = torch.zeros(300, 432, device="meta")
    c = torch.zeros(300, device="meta")
    HK.rotation_cumprod(ur, ur, c, c)  # meta tensors report address 0: aligned
    plan = HK.rotation_plan(300, 432)
    assert plan.wide and calls[0][1][-5:] == (300, 432, 1, plan.smem, plan.blocks)


@pytest.mark.parametrize("with_phasor", [False, True])
def test_vocoder_wrapper_raises_on_bad_tables_and_devices(monkeypatch, with_phasor):
    z = torch.zeros(2, 9, 10, dtype=torch.complex64)
    i0, i1, frac = PS._pv_indices(10, 0.8)
    kw = dict(with_phasor=with_phasor)
    with pytest.raises(ValueError, match="lie in"):
        HK.phase_vocoder_fused(z, i0, np.full_like(i1, 10), frac, **kw)
    late = i0.copy()
    late[0] = 1
    with pytest.raises(ValueError, match="frame 0"):
        HK.phase_vocoder_fused(z, late, i1, frac, **kw)
    with pytest.raises(ValueError, match="one nonzero length"):
        HK.phase_vocoder_fused(z, i0, i1[:-1], frac, **kw)

    def missing(name):
        raise RuntimeError(f"cannot load the {name} kernel library")

    monkeypatch.setattr(_build, "library", missing)
    with pytest.raises(RuntimeError, match="phase_vocoder kernel library"):
        HK.phase_vocoder_fused(z.to("meta"), i0, i1, frac, **kw)


def test_rotation_wrapper_raises_on_bad_planes_and_devices(monkeypatch):
    with pytest.raises(ValueError, match="nonempty"):
        HK.rotation_cumprod(*(torch.zeros(2, 0, device="meta"),) * 2,
                            *(torch.zeros(2, device="meta"),) * 2)

    class _Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(_build, "library", lambda name: _Lib())
    with pytest.raises(RuntimeError, match="expected CUDA tensors"):
        HK.rotation_cumprod(*(torch.zeros(2, 5, device="meta"),) * 2,
                            *(torch.zeros(2, device="meta"),) * 2)
