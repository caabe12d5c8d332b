"""The schedules of two redesigned kernels, held on the CPU (a CUDA kernel
cannot run here; the smoke run holds the kernels themselves to their plain
versions and to their earlier designs on the card).

- B18, the two passes of ``S x`` in bundle adjustment's Schur-complement CG
  (``csrc/schur_cg.cu``, ``schur_cg_kernel``): a numpy twin of its sums
  (:func:`b18_sums`: P sorted positions a thread
  added serially in float64, a segmented warp scan, the warps' carries in
  order, the keys that cross a chunk summed in chunk order) writes every key
  once and lies within 1 float32 ulp of ``models/ba.py::_Segments`` (both sum
  in float64 and round once; the orders differ) on empty keys, runs of 255,
  256, 257 and 3,000 positions, keys outside the range and N not a multiple
  of the chunk, at each thread count and P that the kernel was swept at; and
  the Python chunk is the source's.
- K3 at a stride (``csrc/march.cu``, ``march_group_kernel<G>``): a torch twin
  of its group schedule (lane j reads step k0 + j of a round of G, the serial
  rule replayed with lane j - 1's sample as prev and lane 0's carried from the
  last lane of the round before, the first crossing and death the lowest lanes
  whose tests fire, a stop once both are known) equal to
  ``kernels.march_fixed_plain`` bit for bit on ``ray_dir[:, ::s, ::s]`` at s =
  2 and 4 for every G from 1 to 32: a sphere's volume seen from inside it
  (crossings, deaths at the far side, rays that miss it), from a camera
  looking away (no crossing), from outside the volume (a death at step 0, a
  crossing after), with NaN and infinite rays; and G by the number of rays
  (``kernels.march_lanes``).
"""

import re

import numpy as np
import pytest
import torch

from xslam_tpu_torch.csfd.single import CSFD
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.models import ba as tba
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops.kernels import INF_T, RAY_MIN_M
from xslam_tpu_torch.ops.sampling import gather3d, to_index


# ------------------------------------------------------------------ B18
def b18_sums(keys, rows, start, end, threads: int, per_thread: int, warp: int = 32):
    """A numpy twin of B18's sums (``csrc/schur_cg.cu``, ``schur_cg_kernel``):
    ``rows`` (sorted positions, D; float32) summed by ``keys`` (sorted;
    ``start``, ``end`` each key's segment) in the kernel's order. A chunk of
    ``threads x per_thread`` positions a block; a thread adds its positions'
    runs serially in float64 and writes a run between two key changes at once;
    a segmented inclusive scan of (a run starts in the thread, its last run's
    sum) over each warp of ``warp`` lanes (Hillis-Steele, as the shuffles
    take it) and the warps' totals in order give each thread its first run's
    carry; the first run's end and the last run's are written to the output
    (rounded once), or to the chunk's first or last partial; then each key
    that crosses a chunk is summed in chunk order. Returns (float32 sums,
    times each key was written; an empty key counts as zeroed once)."""
    N, D = rows.shape
    n_keys = len(start)
    P, chunk = per_thread, threads * per_thread
    n_chunks = -(-N // chunk)
    out = np.zeros((n_keys, D), np.float32)
    writes = (start == end).astype(int)
    first, last = np.full((n_chunks, D), np.nan), np.full((n_chunks, D), np.nan)
    zero = np.zeros(D)

    def key_at(pos):
        return int(keys[pos]) if pos < N else -1

    def in_range(k):
        return 0 <= k < n_keys

    def put(c, c0, key, pos, s):
        if not in_range(key):
            return
        if start[key] < c0:
            first[c] = s
        elif end[key] > pos + 1:
            last[c] = s
        else:
            out[key] = s.astype(np.float32)
            writes[key] += 1

    for c in range(n_chunks):
        c0 = c * chunk
        heads, tails = [], []
        for t in range(threads):
            p0 = c0 + t * P
            head_key = key_at(p0)
            run_key, broken, head_end, head, acc = head_key, False, p0 + P - 1, None, None
            for i in range(P):
                pos = p0 + i
                key = head_key if i == 0 else key_at(pos)
                cv = rows[pos].astype(np.float64) if pos < N and in_range(key) else zero
                change = i > 0 and key != run_key
                if change:
                    if broken:
                        put(c, c0, run_key, pos - 1, acc)
                    else:
                        head_end, head = pos - 1, acc
                    broken, run_key = True, key
                acc = cv.copy() if i == 0 or change else acc + cv
            head_starts = t == 0 or key_at(p0 - 1) != head_key
            heads.append((head_key, head_end, head, head_starts, broken))
            tails.append((run_key, acc))
        f = np.array([h[3] or h[4] for h in heads])
        v = np.stack([a for _, a in tails])
        carries = np.zeros((threads, D))
        totals = []  # each warp's inclusive scan at its last lane
        for w0 in range(0, threads, warp):
            fw, vw = f[w0:w0 + warp].copy(), v[w0:w0 + warp].copy()
            off = 1
            while off < warp:
                fu, vu = np.roll(fw, off), np.roll(vw, off, axis=0)
                take = (np.arange(len(fw)) >= off) & ~fw
                vw = np.where(take[:, None], vu + vw, vw)
                fw = np.where(take, fu, fw)
                off *= 2
            carry = zero
            for fo, vo in totals:
                carry = vo if fo else carry + vo
            for lane in range(len(fw)):
                if lane > 0:
                    carry_l = vw[lane - 1] if fw[lane - 1] else carry + vw[lane - 1]
                else:
                    carry_l = carry
                carries[w0 + lane] = carry_l
            totals.append((fw[-1], vw[-1]))
        for t in range(threads):
            head_key, head_end, head, head_starts, broken = heads[t]
            run_key, acc = tails[t]
            own = head if broken else acc
            total = own if head_starts else carries[t] + own
            if broken:
                put(c, c0, head_key, head_end, total)
            p_last = c0 + t * P + P - 1
            if t == threads - 1 or key_at(p_last + 1) != run_key:
                put(c, c0, run_key, p_last, acc if broken else total)
    for c in range(1, n_chunks):
        k = int(keys[c * chunk])
        if not in_range(k) or start[k] // chunk + 1 != c:
            continue
        acc = last[c - 1].copy()
        for cc in range(c, (end[k] - 1) // chunk + 1):
            acc = acc + first[cc]
        out[k] = acc.astype(np.float32)
        writes[k] += 1
    return out, writes


def _ordered(a: np.ndarray) -> np.ndarray:
    i = a.view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _edge_case_keys(chunk: int, seed: int):
    """60 keys with runs of 0 to 3,000 positions (each of 0, 255, 256, 257 and
    3,000 at least once), 9 positions of a key past the range and 4 of -1, N
    not a multiple of ``chunk``; the keys unsorted, rows seeded."""
    rng = np.random.default_rng(seed)
    n_keys = 60
    lengths = rng.choice([0, 1, 2, 5, 17, 255, 256, 257, 3000], n_keys)
    lengths[:5] = (0, 255, 256, 257, 3000)
    tail = 9 + (1 if (lengths.sum() + 13) % chunk == 0 else 0)
    keys = np.concatenate([np.full(n, k) for k, n in enumerate(lengths)] + [np.full(tail, n_keys + 1), [-1] * 4])
    keys = rng.permutation(keys)
    assert len(keys) % chunk != 0
    return keys, rng.normal(0, 1, (len(keys), 12)).astype(np.float32), n_keys


@pytest.mark.parametrize("threads, per_thread", [(256, 1), (256, 2), (256, 4), (256, 8), (128, 4), (128, 8)])
def test_b18_schedule_sums_each_key_once_within_an_ulp(threads, per_thread):
    keys, rows, n_keys = _edge_case_keys(threads * per_thread, threads + per_thread)
    seg = tba._Segments(torch.from_numpy(keys), n_keys)
    ref = seg(torch.from_numpy(rows)).numpy()
    order = seg.order.numpy()
    out, writes = b18_sums(seg.sorted_keys.numpy(), rows[order], seg.start.numpy(), seg.end.numpy(), threads,
                           per_thread)
    assert (writes == 1).all(), writes
    ulps = np.abs(_ordered(out) - _ordered(ref))
    assert ulps.max() <= 1 and (ulps == 0).mean() > 0.9, ulps.max()
    assert not out[np.nonzero(seg.start.numpy() == seg.end.numpy())[0]].any()  # empty keys: zero sums


def _source_constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (kernels.CSRC_DIR / source).read_text()).group(1))


def test_b18_chunk_is_the_sources():
    """``models/ba.py``'s chunk and P are ``csrc/schur_cg.cu``'s (the scratch's rows and the twin's schedule)."""
    threads, per_thread = _source_constant("schur_cg.cu", "CG_THREADS"), _source_constant("schur_cg.cu", "CG_PER_THREAD")
    assert (per_thread, threads * per_thread) == (tba.CG_PER_THREAD, tba.CG_CHUNK)


# ------------------------------------------------------------------ K3 at a stride
N_VOX, VOXEL, TRUNC, RADIUS = 64, 0.04, 0.06, 0.7  # 101 steps of 0.048 m
INTR = Intrinsics(30.0, 30.0, 19.5, 14.5, 40, 30)


def group_march_twin(value, ray_start: CSFD, dirs_v, voxel, trunc_dist, lanes):
    """A torch twin of ``march_group_kernel<lanes>``'s schedule, the events
    as (H, W) planes like :func:`kernels.march_fixed_plain`'s."""
    X, Y, Z = value.shape
    step = np.float32(trunc_dist * 0.8)
    n = kernels.march_steps(trunc_dist)
    H, W = dirs_v.shape[-2:]
    d = dirs_v.reshape(3, -1)
    s = ray_start.v[:, None]

    def voxel_of(p):
        return to_index(torch.floor(p / voxel))

    def inside(g):
        return (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y) & (g[2] >= 0) & (g[2] < Z)

    finite = torch.isfinite(d).all(0) & bool(torch.isfinite(s).all())
    g0 = voxel_of(s + d * RAY_MIN_M)
    prev = gather3d(value, g0[0].clamp(0, X - 1), g0[1].clamp(0, Y - 1), g0[2].clamp(0, Z - 1)) + 1e-5
    t_found = torch.full(finite.shape, INF_T, dtype=torch.float32)
    t_dead = torch.where(finite, t_found, torch.tensor(np.float32(RAY_MIN_M) + np.float32(0) * step))
    marching = finite.clone()
    for k0 in range(0, n, lanes):
        ks = k0 + np.arange(lanes)  # lane j's step
        t_next = torch.from_numpy(np.float32(RAY_MIN_M) + (ks + 1).astype(np.float32) * step)
        t_curr = torch.from_numpy(np.float32(RAY_MIN_M) + ks.astype(np.float32) * step)
        g = voxel_of(s[:, None] + d[:, None, :] * t_next[None, :, None])  # (3, G, R)
        ins = inside(g)
        tsdf = gather3d(value, g[0], g[1], g[2]) + 1e-5
        pv = torch.cat([prev[None], tsdf[:-1]], 0)  # lane j's prev: lane j - 1's sample; lane 0 the carry
        live = torch.from_numpy(ks < n)[:, None]
        death = live & (~ins | ((pv < 0.0) & (tsdf > 0.0)))
        crossing = live & ins & (pv > 0.0) & (tsdf < 0.0)
        for events, times in ((crossing, t_found), (death, t_dead)):
            lowest = torch.argmax(events.to(torch.int32), 0)  # the lowest lane that fires (a ballot's ffs)
            hit = marching & events.any(0) & (times >= INF_T)
            times.copy_(torch.where(hit, t_curr[lowest], times))
        prev = torch.where(marching, tsdf[-1], prev)  # the last lane's sample
        marching = marching & ~((t_found < INF_T) & (t_dead < INF_T))
        if not bool(marching.any()):
            break
    return t_found.reshape(H, W), t_dead.reshape(H, W)


def _sphere_value():
    c = (np.arange(N_VOX, dtype=np.float32) + 0.5) * VOXEL - 0.5 * N_VOX * VOXEL
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    return torch.from_numpy(np.clip((r - RADIUS) / TRUNC, -1.0, 1.0).astype(np.float32))


def _look(eye, target):
    z = np.asarray(target, np.float32) - np.asarray(eye, np.float32)
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0.0, 0.0, 1.0], np.float32), z)
    x /= np.linalg.norm(x)
    c2v = np.eye(4, dtype=np.float32)
    c2v[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    c2v[:3, 3] = eye
    return c2v


def _rays(c2v):
    r = CSFD(torch.from_numpy(np.ascontiguousarray(c2v[:3, :3])), torch.zeros(3, 3))
    t = CSFD(torch.from_numpy(np.ascontiguousarray(c2v[:3, 3])), torch.zeros(3))
    return kernels.camera_rays(r, t, INTR)  # (ray_dir, ray_start)


def _cameras():
    """(name, ray_dir values, ray_start) of the cases in the module docstring."""
    mid = 0.5 * N_VOX * VOXEL
    out = {}
    for name, eye, target in (("inside", (0.1, 0.1, 0.1), (mid, mid, mid)),
                              ("away", (mid + 0.9, mid, mid), (2 * N_VOX * VOXEL, mid, mid)),
                              ("outside", (-0.5, mid + 0.1, mid - 0.1), (mid, mid, mid))):
        ray_dir, ray_start = _rays(_look(eye, target))
        out[name] = (ray_dir.v, ray_start)
    dirs = out["inside"][0].clone()
    dirs[:, :, ::6] = float("nan")
    dirs[1, ::5, :] = float("inf")
    out["odd"] = (dirs, out["inside"][1])
    return out


@pytest.fixture(scope="module")
def sphere():
    value = _sphere_value()
    runs = {}
    for name, (dirs, ray_start) in _cameras().items():
        for s in (2, 4):
            d = dirs[:, ::s, ::s]
            runs[name, s] = (d, ray_start, kernels.march_fixed_plain(value, ray_start, CSFD(d, d), VOXEL, TRUNC))
    return value, runs


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_group_schedule_equals_the_plain_march(sphere, lanes):
    value, runs = sphere
    for (name, s), (d, ray_start, (pf, pd)) in runs.items():
        tf, td = group_march_twin(value, ray_start, d, VOXEL, TRUNC, lanes)
        assert torch.equal(tf.view(torch.int32), pf.view(torch.int32)), (name, s)
        assert torch.equal(td.view(torch.int32), pd.view(torch.int32)), (name, s)


def test_group_cases_cover_the_events(sphere):
    """The cases hold what the schedule must replay: crossings past a round
    of 16 lanes and deaths past a round of 32, rays with no crossing, a camera
    outside (a death at step 0, then a crossing), NaN and infinite rays."""
    _, runs = sphere
    t0, step = np.float32(RAY_MIN_M), np.float32(TRUNC * 0.8)
    _, _, (f_in, d_in) = runs["inside", 2]
    assert bool((f_in < INF_T).any()) and bool((f_in == INF_T).any()) and bool((d_in < INF_T).all())
    assert float(f_in[f_in < INF_T].max()) > t0 + 16 * step
    assert float(d_in.max()) > t0 + 32 * step
    _, _, (f_away, _) = runs["away", 4]
    assert bool((f_away == INF_T).all())
    _, _, (f_out, d_out) = runs["outside", 2]
    assert bool((d_out == t0).all()) and bool((f_out < INF_T).any())
    d_odd, _, (f_odd, dd_odd) = runs["odd", 2]
    bad = ~torch.isfinite(d_odd).all(0)
    assert bool(bad.any()) and bool((f_odd[bad] == INF_T).all()) and bool((dd_odd[bad] == t0).all())


def test_lanes_by_the_number_of_rays():
    """Stride 1 keeps a thread a ray (K3's body); at a stride the least power
    of two whose lanes fill the card, at most 32: hier's 240 x 320 rays and
    hier2's 120 x 160."""
    fill, most = kernels.MARCH_FILL_THREADS, kernels.MARCH_MAX_LANES
    assert kernels.march_lanes(480, 640, 1) == kernels.march_lanes(60, 80, 1) == 1
    for H, W in ((240, 320), (120, 160), (60, 80), (2, 3), (480, 640)):
        g = kernels.march_lanes(H, W, 2)
        assert g & (g - 1) == 0 and 1 <= g <= most
        assert g == most or H * W * g >= fill
        assert g == 1 or H * W * (g // 2) < fill
    assert kernels.march_lanes(240, 320, 2) == 4 and kernels.march_lanes(120, 160, 4) == 16
