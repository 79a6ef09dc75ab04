"""The round epilogue's per-row arithmetic (``csrc/round_epilogue.cuh``) on
the host.

The header holds the stopping rule and the label freeze that the round
epilogue kernel (kernel ``csrc/round_epilogue.cu``, wrapper
``ops/round_epilogue_cuda.py``) runs for each buffer row after a round's
counts. Here it is compiled with g++ and ``-ffp-contract=off``, with the
CUDA rounding intrinsics it uses stubbed as the plain float operations
(the same IEEE single-precision operations), and held bit for bit to
`mc.stats` (``calc_slack``, ``get_bin``, ``is_converged``), to the JAX
package's ``collide2d_tpu.mc.stats`` on the same rows, and to the plain
round update (`round_epilogue_cuda.round_update_plain`):

- every k at small n, and k in {0, 1, n - 1, n} for n up to past the 4e6
  cap, k past 46,340 (where the reference's int32 k^2 overflows), k just
  under n up to 2^31 (where float32 k equals n), and a slack equal to its
  bin's target;
- p = k / n on both sides of, and exactly on, each bin edge;
- multi-round runs in which rows converge and then unconverge: they stay
  frozen;
- the reference bins and two other bin tables (one with overlapping bins,
  where the last match wins).

It also holds the Python side of the kernel's arguments (`stop_rule`,
the shared float32 constants) and the rule's validation. It skips only
where g++ is absent.
"""

import shutil
import struct
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collide2d_tpu.mc import stats as jstats
from collide2d_tpu_torch.mc import stats
from collide2d_tpu_torch.ops import round_epilogue_cuda as rec
from collide2d_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

# (edges, targets): the reference's, the driver test's, and one whose bins
# overlap (0.2-0.3 lies in bins 0 and 2, so the scan's last match wins).
BIN_TABLES = {
    "reference": ((0.0, 0.01, 0.1, 1.0), (0.0001, 0.001, 0.01)),
    "driver_test": ((0.0, 0.01, 0.1, 1.0), (0.002, 0.005, 0.02)),
    "overlapping": ((0.0, 0.3, 0.2, 0.55, 1.0), (0.004, 0.0005, 0.003, 0.02)),
}

_PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <math.h>

#define __device__
#define __forceinline__ inline
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fsub_rn(float a, float b) { return a - b; }

#include "round_epilogue.cuh"

using namespace collide2d::round_epilogue;

// RULE: z, ln(1/alpha) (float), n_bins (int32), n_bins + 1 edges, n_bins
// targets (float). IN: records of 7 int32 words: n_after, n_f (float
// bits), n_true, counts, done, k_frozen, n_frozen. OUT: records of 7
// words: n_true, done, k_frozen, n_frozen, the rule's verdict on them, its
// slack (float bits) and bin.
int main(int argc, char** argv) {
  if (argc != 4) return 2;
  FILE* rf = fopen(argv[1], "rb");
  StopRule r;
  if (fread(&r.z, 4, 1, rf) != 1 || fread(&r.log_inv_alpha, 4, 1, rf) != 1 ||
      fread(&r.n_bins, 4, 1, rf) != 1 || r.n_bins < 1 || r.n_bins > kMaxBins)
    return 3;
  if (fread(r.edge, 4, r.n_bins + 1, rf) != static_cast<size_t>(r.n_bins + 1) ||
      fread(r.target, 4, r.n_bins, rf) != static_cast<size_t>(r.n_bins))
    return 3;
  fclose(rf);
  FILE* in = fopen(argv[2], "rb");
  FILE* out = fopen(argv[3], "wb");
  int32_t w[7];
  while (fread(w, 4, 7, in) == 7) {
    float n_f;
    memcpy(&n_f, &w[1], 4);
    int32_t n_true = w[2], k_frozen = w[5], n_frozen = w[6];
    bool done = w[4] != 0;
    update_row(n_true, done, k_frozen, n_frozen, w[3], w[0], n_f, r);
    const float k = static_cast<float>(n_true);
    const float slack = calc_slack(n_f, k, r);
    int32_t o[7] = {n_true, done ? 1 : 0, k_frozen, n_frozen,
                    is_converged(n_f, n_true, r) ? 1 : 0, 0, get_bin(__fdiv_rn(k, n_f), r)};
    memcpy(&o[5], &slack, 4);
    fwrite(o, 4, 7, out);
  }
  fclose(in);
  fclose(out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def epilogue_program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/round_epilogue.cuh on the host")
    work = tmp_path_factory.mktemp("round_epilogue")
    src = work / "round_epilogue_host.cc"
    src.write_text(_PROGRAM)
    exe = work / "round_epilogue_host"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I",
                    str(cuda_build.CSRC_DIR), "-o", str(exe), str(src)], check=True,
                   capture_output=True, timeout=300)
    return exe, work


def _host_round(program, table: str, n_after, n_true, counts, done, k_frozen, n_frozen):
    """One round of every row through the compiled header: (n_true, done,
    k_frozen, n_frozen, conv, slack, bin) as numpy arrays."""
    exe, work = program
    z, lia, edges, targets = rec.stop_rule(*BIN_TABLES[table])
    rule = work / f"rule_{table}.bin"
    rule.write_bytes(struct.pack(f"<ffi{len(edges)}f{len(targets)}f", z, lia,
                                 len(targets), *edges, *targets))
    m = len(n_true)
    n_after = np.broadcast_to(np.asarray(n_after, np.int64), (m,))
    rec_in = np.empty((m, 7), np.int32)
    rec_in[:, 0] = n_after
    rec_in[:, 1] = n_after.astype(np.float32).view(np.int32)
    rec_in[:, 2], rec_in[:, 3] = n_true, counts
    rec_in[:, 4], rec_in[:, 5], rec_in[:, 6] = done, k_frozen, n_frozen
    (work / "in.bin").write_bytes(rec_in.tobytes())
    subprocess.run([str(exe), str(rule), str(work / "in.bin"), str(work / "out.bin")],
                   check=True, timeout=120)
    o = np.frombuffer((work / "out.bin").read_bytes(), np.int32).reshape(m, 7)
    return (o[:, 0], o[:, 1].astype(bool), o[:, 2], o[:, 3], o[:, 4].astype(bool),
            o[:, 5].view(np.float32), o[:, 6])


def _check_rule(program, table, n, k):
    """The header's slack (bits), bin and verdict on (n, k) rows against
    `mc.stats` and the JAX package's, through one round from a fresh state
    with counts k."""
    n, k = np.asarray(n, np.int64), np.asarray(k, np.int32)
    m = len(k)
    zeros = np.zeros(m, np.int32)
    got = _host_round(program, table, n, zeros, k, np.zeros(m, bool), zeros,
                      np.ones(m, np.int32))
    nt, kt = torch.from_numpy(n.astype(np.float32)), torch.from_numpy(k)
    edges, targets = BIN_TABLES[table]
    slack = stats.calc_slack(nt, kt).numpy()
    kf = kt.to(torch.float32)
    bins = stats.get_bin(kf / nt, edges).numpy()
    conv = stats.is_converged(nt, kt, edges, targets).numpy()
    np.testing.assert_array_equal(got[5].view(np.int32), slack.view(np.int32))
    np.testing.assert_array_equal(got[6], bins)
    np.testing.assert_array_equal(got[4], conv)
    nj, kj = jnp.asarray(n.astype(np.float32)), jnp.asarray(k)
    j_slack = np.asarray(jstats.calc_slack(nj, kj))
    np.testing.assert_array_equal(got[5].view(np.int32), j_slack.view(np.int32))
    np.testing.assert_array_equal(
        got[6], np.asarray(jstats.get_bin(kj.astype(jnp.float32) / nj, jnp.asarray(edges))))
    np.testing.assert_array_equal(
        got[4], np.asarray(jstats.is_converged(nj, kj, jnp.asarray(edges),
                                               jnp.asarray(targets))))
    # a fresh row freezes exactly where the rule holds
    np.testing.assert_array_equal(got[1], conv)
    np.testing.assert_array_equal(got[2], np.where(conv, k, 0))
    np.testing.assert_array_equal(got[3], np.where(conv, n, 1))
    return conv


@pytest.mark.parametrize("table", sorted(BIN_TABLES))
def test_every_k_at_small_n(epilogue_program, table):
    n = np.concatenate([np.full(m + 1, m) for m in (1, 2, 3, 7, 64, 100, 1000, 1024, 4096)])
    k = np.concatenate([np.arange(m + 1) for m in (1, 2, 3, 7, 64, 100, 1000, 1024, 4096)])
    conv = _check_rule(epilogue_program, table, n, k)
    assert 0 < conv.sum() < len(conv) or table == "reference"


@pytest.mark.parametrize("table", sorted(BIN_TABLES))
def test_extreme_k_up_to_the_cap(epilogue_program, table):
    rng = np.random.default_rng(5)
    ns = np.unique(np.concatenate([
        np.geomspace(2, 4_100_000, 300).astype(np.int64),
        [20_000, 36_888, 36_889, 36_928, 46_340, 46_341, 100_000, 3_999_999,
         4_000_000, 4_000_064, 4_100_032],
        rng.integers(2, 4_100_000, 200)]))
    n = np.repeat(ns, 4)
    k = np.stack([np.zeros_like(ns), np.ones_like(ns), ns - 1, ns], axis=1).ravel()
    conv = _check_rule(epilogue_program, table, n, k)
    # k = 0 and k = n converge by the rule of three at large n, not below
    assert conv[k == 0].any() and not conv[k == 0].all()


@pytest.mark.parametrize("table", sorted(BIN_TABLES))
def test_k_past_46340_at_large_n(epilogue_program, table):
    rng = np.random.default_rng(7)
    n = rng.integers(46_341, 4_100_000, 20_000)
    k = rng.integers(46_341, n + 1)
    _check_rule(epilogue_program, table, n, k.astype(np.int64))


@pytest.mark.parametrize("table", sorted(BIN_TABLES))
def test_k_near_n_past_the_cap(epilogue_program, table):
    # up to n_after's 2^31 limit: k just under n rounds to n in float32,
    # where the rule takes the rule of three
    rng = np.random.default_rng(9)
    n = rng.integers(10_000_000, 2**31 - 1, 2_000)
    k = n - rng.integers(1, 3_000, 2_000)
    conv = _check_rule(epilogue_program, table, n, k)
    assert (k.astype(np.float32) == n.astype(np.float32)).any() and conv.any()


def test_a_slack_equal_to_its_target_converges(epilogue_program):
    # (111,828, 3,356) at the reference bins: p in bin 1, whose target the
    # float32 slack equals exactly (the rule is slack <= target)
    n, k = np.array([111_828]), np.array([3_356])
    edges, targets = BIN_TABLES["reference"]
    slack = stats.calc_slack(torch.tensor([111_828.0]), torch.tensor([3_356], dtype=torch.int32))
    assert float(slack[0]) == float(np.float32(targets[1]))
    assert _check_rule(epilogue_program, "reference", n, k).all()


@pytest.mark.parametrize("table", sorted(BIN_TABLES))
def test_p_on_both_sides_of_each_bin_edge(epilogue_program, table):
    edges = BIN_TABLES[table][0]
    ns = np.unique(np.concatenate([[100, 1000, 1024, 10_000, 20_000, 100_000,
                                    1_000_000, 4_000_000],
                                   np.random.default_rng(11).integers(50, 4_000_000, 60)]))
    n, k = [], []
    for e in edges:
        for m in ns:
            for d in range(-3, 4):
                kk = int(np.floor(e * m)) + d
                if 0 <= kk <= m:
                    n.append(m)
                    k.append(kk)
    n, k = np.asarray(n), np.asarray(k)
    _check_rule(epilogue_program, table, n, k)
    # p lands exactly on an inner edge somewhere (the scan's inclusive ends)
    p = (k.astype(np.float32) / n.astype(np.float32)).astype(np.float32)
    assert np.isin(p, np.asarray(edges[1:-1], np.float32)).any()


@pytest.mark.parametrize("table", sorted(BIN_TABLES))
def test_multi_round_runs_stay_frozen(epilogue_program, table):
    # Each row's probability is drawn anew every round, so its running
    # estimate wanders in and out of its bin's target: rows converge, then
    # unconverge. The header's state must equal the plain update's after
    # every round, and a row that froze keeps its first k and n.
    rng = np.random.default_rng(13)
    edges, targets = BIN_TABLES[table]
    probs = np.array([0.0, 1e-4, 5e-4, 0.002, 0.008, 0.03, 0.12, 0.25, 0.5, 0.9,
                      0.99, 1.0])
    m = 4096
    n_true = np.zeros(m, np.int32)
    done = np.zeros(m, bool)
    k_frozen = np.zeros(m, np.int32)
    n_frozen = np.ones(m, np.int32)
    want = tuple(torch.from_numpy(a.copy()) for a in (n_true, done, k_frozen, n_frozen))
    n_after, unconverged_after_freeze = 0, 0
    for r in range(16):
        nb = 1_000 if r < 8 else 20_000
        n_after += nb
        counts = rng.binomial(nb, probs[rng.integers(0, len(probs), m)]).astype(np.int32)
        was = (done.copy(), k_frozen.copy(), n_frozen.copy())
        n_true, done, k_frozen, n_frozen, conv, _, _ = _host_round(
            epilogue_program, table, n_after, n_true, counts, done, k_frozen, n_frozen)
        *want, _ = rec.round_update_plain(*want, torch.from_numpy(counts), n_after,
                                          edges, targets)
        for got, w in zip((n_true, done, k_frozen, n_frozen), want):
            np.testing.assert_array_equal(got, w.numpy())
        np.testing.assert_array_equal(k_frozen[was[0]], was[1][was[0]])
        np.testing.assert_array_equal(n_frozen[was[0]], was[2][was[0]])
        assert done[was[0]].all()
        unconverged_after_freeze += int((done & ~conv).sum())
    assert unconverged_after_freeze > 0
    assert len(np.unique(n_frozen[done])) > 3  # rows froze in many rounds


def test_stop_rule_is_the_stats_constants():
    z, lia, edges, targets = rec.stop_rule((0.0, 0.01, 0.1, 1.0), (1e-4, 1e-3, 1e-2))
    assert z == float(np.float32(stats.Z_SCORE))
    assert lia == float(np.float32(np.log(40.0)))
    assert edges == tuple(float(np.float32(e)) for e in (0.0, 0.01, 0.1, 1.0))
    assert targets == tuple(float(np.float32(t)) for t in (1e-4, 1e-3, 1e-2))
    with pytest.raises(ValueError, match="one target per bin"):
        rec.stop_rule((0.0, 1.0), (0.1, 0.2))
    with pytest.raises(ValueError, match="one target per bin"):
        rec.stop_rule((0.0,), ())


def test_round_update_on_the_cpu_is_the_plain_update():
    # CPU tensors never launch: round_update is round_update_plain
    rng = np.random.default_rng(17)
    m = 500
    state = (torch.from_numpy(rng.integers(0, 1000, m).astype(np.int32)),
             torch.from_numpy(rng.random(m) < 0.3),
             torch.from_numpy(rng.integers(0, 1000, m).astype(np.int32)),
             torch.from_numpy(rng.integers(1, 5000, m).astype(np.int32)))
    counts = torch.from_numpy(rng.integers(0, 64, m).astype(np.int32))
    uids = torch.from_numpy(np.where(rng.random(m) < 0.9, np.arange(m), -1).astype(np.int32))
    edges, targets = BIN_TABLES["driver_test"]
    copy = lambda: tuple(t.clone() for t in state)  # noqa: E731
    before = rec.LAUNCHES
    mine = copy()
    got = rec.round_update(*mine, counts, 6000, edges, targets, uids=uids)
    want = rec.round_update_plain(*copy(), counts, 6000, edges, targets, uids)
    assert all(g is t for g, t in zip(got[:4], mine))  # in place, as on the card
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert int(got[4]) == int(((got[1]) & (uids >= 0)).sum())
    assert rec.LAUNCHES == before
    # without uids no count; with counts None n_true already holds them
    into = copy()
    into[0].add_(counts)
    again = rec.round_update(*into, None, 6000, edges, targets)
    assert again[4] is None
    for g, w in zip(again[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("current", [0, 1])
def test_launch_switches_the_device_only_when_it_must(monkeypatch, current):
    # the round path's C launchers run on the tensors' device and its
    # current stream; the device is switched only when another is current
    entered = []

    class Device:
        def __init__(self, idx):
            self.idx = idx

        def __enter__(self):
            entered.append(self.idx)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda idx: 1000 + idx,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", Device)
    got = cuda_build.launch(torch.device("cuda", 1), lambda *args: args, "params", 7)
    assert got == ("params", 7, 1001)
    assert entered == ([] if current == 1 else [1])
