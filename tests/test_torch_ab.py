"""The A/B tools' shared helper (`utils/ab.py`) and query_ab's build list on
the CPU.

`ab.swapped` puts another version's library into a wrapper module and
gives the wrapper its own back; `ab.in_turns` runs a call in turns (other,
this, this, other) and says whether every turn's outputs are equal. A
stand-in for `chip_smoke` (timer and fingerprint) and a stand-in module
replace the card. `query_ab` builds the other version of kernels 6, 9 and
10 once for each bucket pair above 16 only where its source reads the
bucket defines (the earlier design), and picks that library for a case.
"""

import types

import pytest
import torch

from collide2d_tpu_torch.utils import ab, cuda_build, query_ab

torch.set_num_threads(1)


def _module():
    """A wrapper module's stand-in: its `_kernel_lib` returns "own"."""
    mod = types.ModuleType("wrapper")
    mod._kernel_lib = lambda *args, **kw: "own"
    return mod


def _cs(calls):
    return types.SimpleNamespace(
        _events_ms=lambda fn, reps: calls.append(reps) or 1.0,
        output_fingerprint=lambda *outs: [[len(outs), int(sum(o.sum() for o in outs))]])


def test_swapped_puts_a_library_in_and_takes_it_out():
    mod = _module()
    with ab.swapped({mod: "other"}):
        assert mod._kernel_lib() == "other" and mod._kernel_lib(4, 32, x=1) == "other"
    assert mod._kernel_lib() == "own"
    with ab.swapped({}):
        assert mod._kernel_lib() == "own"
    with pytest.raises(ValueError):
        with ab.swapped({mod: "other"}):
            raise ValueError
    assert mod._kernel_lib() == "own"


@pytest.mark.parametrize("tuple_out", [False, True])
def test_in_turns_times_each_turn_and_compares_the_outputs(tuple_out):
    mod = _module()
    seen = []

    def fn():
        seen.append(mod._kernel_lib())
        out = torch.ones(3)
        return (out, 2 * out) if tuple_out else out

    calls = []
    row, first = ab.in_turns(_cs(calls), {mod: "other"}, fn, reps=5)
    # each turn: one call, then the timer's (not called here: a stand-in)
    assert seen == ["other", "own", "own", "other"] and calls == [5] * 4
    assert row["outputs_equal"] and row["ms_other"] == [1.0, 1.0] == row["ms_this"]
    assert row["speedup"] == 1.0
    assert row["fingerprint"] == ([[2, 9]] if tuple_out else [[1, 3]])
    assert torch.equal(first[0] if tuple_out else first, torch.ones(3))


def test_in_turns_sees_a_turn_that_differs():
    mod = _module()
    row, _ = ab.in_turns(_cs([]), {mod: "other"},
                         lambda: torch.full((2,), float(mod._kernel_lib() == "own")),
                         reps=None)
    assert not row["outputs_equal"] and "ms_other" not in row


def test_query_ab_builds_bucket_pairs_only_for_the_earlier_design(tmp_path):
    earlier = tmp_path / "csrc"
    earlier.mkdir()
    for name in ("polygon_kernel", "manifold_kernel", "distance_kernel", "toi_kernel"):
        (earlier / f"{name}.cu").write_text("#if POLY_KB1\n#endif\n")
    jobs = query_ab._jobs(["6", "10", "9", "12"], earlier)
    buckets = [query_ab._bucket_defines(*kk) for kk in query_ab._BIG_K_BUCKETS]
    assert buckets == [(("POLY_KB1", 4), ("POLY_KB2", 32)), (("POLY_KB1", 4), ("POLY_KB2", 64)),
                       (("POLY_KB1", 32), ("POLY_KB2", 32))]
    for k in ("6", "10", "9"):
        assert [d for tag, kk, _, d in jobs if tag == "other" and kk == k] == [(), *buckets]
        assert [d for tag, kk, _, d in jobs if tag == "this" and kk == k] == [()]
    assert [d for _, kk, _, d in jobs if kk == "12"] == [(), ()]  # kernel 12: no K
    # this checkout's kernels 6, 9 and 10 take every K in one library
    jobs = query_ab._jobs(["6", "10", "9"], cuda_build.CSRC_DIR)
    assert [d for *_, d in jobs] == [()] * 6
    libs = {(): "default", **{d: f"lib{i}" for i, d in enumerate(buckets)}}
    assert query_ab._other_lib(libs, 4, 20) == "lib0"
    assert query_ab._other_lib(libs, 20, 20) == "lib2"
    assert query_ab._other_lib(libs, 4, 8) == "default"
    assert query_ab._other_lib({(): "default"}, 32, 32) == "default"
