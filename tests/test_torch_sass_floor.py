"""The SASS path search behind `chip_smoke.py`'s issue floors, on the CPU.

`chip_smoke._shortest_iteration` walks one iteration of a loop in the
kernel's SASS, each conditional forward branch either way, and gives the
fewest instructions a warp can issue for it. Kernel 11's floor asks for the
shortest path among those that divide most often (``most``): its early
exit's vote branches past the shape's later faces, and the floor is the
path through every face with the votes issued and not taken. Here both
searches run on a hand-written loop of that form. Kernel 12's floor
(`toi_issue_floor`) and kernel 9's (`polygon_distance_issue_floor`) are
held to the counts of hand-written SASS of their kernels' forms: kernel
12's refill loop and stepping loop, kernel 9's first pass and its loop
over the pairs it lists.
"""

import pytest
import torch

import chip_smoke as cs

torch.set_num_threads(1)

# A shape loop: two faces, the warp's vote and its exit past the last two
# faces, a hit test whose FSEL a branch may skip, the backward branch.
_SHAPE_LOOP = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R0] ;
        /*0020*/                   MUFU.RCP R5, R6 ;
        /*0030*/                   FFMA R7, R5, R6, R7 ;
        /*0040*/                   MUFU.RCP R8, R9 ;
        /*0050*/                   VOTE.ALL R10, PT, P0 ;
        /*0060*/              @P0  BRA 0xb0 ;
        /*0070*/                   MUFU.RCP R11, R12 ;
        /*0080*/                   MUFU.RCP R13, R14 ;
        /*0090*/              @P2  BRA 0xb0 ;
        /*00a0*/                   FSEL R15, R16, R17, P3 ;
        /*00b0*/                   IADD3 R0, R0, 0x40, RZ ;
        /*00c0*/              @P1  BRA 0x10 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0 ;
"""


def _ins(text: str) -> list:
    return [(int(a, 16), pred.strip(), op, args)
            for a, pred, op, args in cs._SASS_LINE.findall(text) if op != "NOP"]


def test_shape_loop_is_the_dividing_loop():
    ins = _ins(_SHAPE_LOOP)
    loop = cs.raycast_shape_loop(ins)
    assert (loop["start"], loop["end"], loop["instructions"], loop["lds"]) == (0x10, 0xc0, 12, 1)


@pytest.mark.parametrize("most,want", [
    (False, (8, 1, 2)),  # the vote's exit taken after two faces
    (True, (11, 1, 4)),  # every face, the vote not taken, the FSEL skipped
])
def test_shortest_iteration_through_the_shape_loop(most, want):
    ins = _ins(_SHAPE_LOOP)
    assert cs._shortest_iteration(ins, 0x10, 0xc0, also=("MUFU.RCP",), most=most) == want


def test_shortest_iteration_without_a_path_raises():
    ins = _ins(_SHAPE_LOOP)
    with pytest.raises(RuntimeError, match="no path"):
        cs._shortest_iteration(ins, 0xd0, 0xe0)


def _assemble(lines: list) -> list:
    """(label or None, predicate, opcode, operands) lines at 0x10 apart ->
    `_sass_function`'s tuples; an operand ``@name`` is the address of the
    line labelled ``name``."""
    where = {label: 16 * i for i, (label, *_rest) in enumerate(lines) if label}
    out = []
    for i, (_, pred, op, args) in enumerate(lines):
        args = " ".join(f"{where[a[1:]]:#x}" if a.startswith("@") else a for a in args.split())
        out.append((16 * i, pred, op, args))
    return out


# Kernel 12's form: the refill loop (the pairs' loads; a rotating pair's
# bound, three MUFU.RSQ; a translating pair's window, four MUFU.RCP and its
# store), then the stepping loop (the held pair's evaluation, one MUFU.RSQ,
# with a nested slow-path loop that also loads; the settle store or the
# step's division), the drained warp's exit and the back edge.
_TOI = _assemble([
    (None, "", "S2R", "R0, SR_TID.X"),
    ("top", "", "VOTE.ANY", "R1, PT, P0"),
    (None, "@P1", "BRA", "@step"),
    ("refill", "", "POPC", "R2, R1"),
    (None, "@P2", "BRA", "@ballot"),
    (None, "", "LDG.E.CONSTANT", "R3, desc[UR4][R4.64]"),
    (None, "", "LDG.E.CONSTANT", "R5, desc[UR4][R6.64]"),
    (None, "@P3", "BRA", "@window"),
    (None, "", "MUFU.RSQ", "R7, R8"),
    (None, "", "MUFU.RSQ", "R9, R10"),
    (None, "", "MUFU.RSQ", "R11, R12"),
    (None, "", "BRA", "@ballot"),
    ("window", "", "MUFU.RCP", "R13, R14"),
    (None, "", "MUFU.RCP", "R15, R16"),
    (None, "", "MUFU.RCP", "R17, R18"),
    (None, "", "MUFU.RCP", "R19, R20"),
    (None, "", "STG.E", "desc[UR4][R22.64], R21"),
    ("ballot", "", "VOTE.ANY", "R1, PT, P0"),
    (None, "@P4", "BRA", "@refill"),
    ("step", "@!P5", "BRA", "@vote"),
    (None, "", "FADD", "R23, R24, R25"),
    (None, "@!P7", "BRA", "@fast"),
    ("slow", "", "LDG.E.CONSTANT", "R26, desc[UR4][R27.64]"),
    (None, "@P7", "BRA", "@slow"),
    ("fast", "", "MUFU.RSQ", "R28, R29"),
    (None, "@P6", "BRA", "@advance"),
    (None, "", "STG.E", "desc[UR4][R30.64], R31"),
    (None, "", "BRA", "@vote"),
    ("advance", "", "MUFU.RCP", "R32, R33"),
    ("vote", "", "VOTE.ANY", "R1, PT, P0"),
    (None, "@P0", "BRA", "@step"),
    (None, "@!P0", "EXIT", ""),
    (None, "", "BRA", "@top"),
])


def _patched(monkeypatch, ins):
    monkeypatch.setattr(cs, "_sass_function", lambda lib, kernel: ins)
    monkeypatch.setattr(cs, "_sm_clock_hz", lambda: (1.98e9, 1.98e9))


def test_toi_issue_floor_on_the_refill_and_stepping_loops(monkeypatch):
    _patched(monkeypatch, _TOI)
    work = dict(pairs=3, rotating=2, translating=1, evals=10.0, warp_max_evals=64.0)
    floor = cs.toi_issue_floor(None, work)
    # an evaluation: the test, FADD, the slow path skipped, MUFU.RSQ, the
    # step's branch, its MUFU.RCP, the vote and the back edge
    assert floor["sass_per_evaluation"] == 8
    # the refill loop's shortest iteration is POPC, BRA, VOTE, BRA (4): a
    # set-up adds the loads, the window test, the three RSQ and a BRA (7),
    # a window the loads, the test, four RCP and the store (8)
    assert (floor["sass_setup"], floor["sass_window"]) == (7, 8)
    assert floor["issue_floor_ms"] == pytest.approx(cs._issue_ms(10 * 8 + 2 * 7 + 8)[0])
    assert floor["issue_floor_ms_at_warp_max"] == pytest.approx(
        cs._issue_ms(64 * 8 + 2 * 7 + 8)[0])


def _distance_sass(kb: int) -> list:
    """Kernel 9's form at K1 = K2 = kb: the first pass between the first two
    barriers (the pair's loads, its first normals, the appends), then the
    loop over the listed pairs (their loads; an undecided pair's every
    axis, a MUFU.RSQ each, and the overlap's store; every test's FMUL.SAT,
    the sqrt and the store)."""
    planes = [(None, "", "LDG.E.CONSTANT", f"R{i}, desc[UR4][R2.64]") for i in range(4 * kb)]
    return _assemble([
        (None, "", "S2R", "R0, SR_TID.X"),
        (None, "", "BAR.SYNC.DEFER_BLOCKING", "0x0"),
        (None, "@P0", "BRA", "@first_done"),
        *planes,
        (None, "", "FMNMX", "R1, R2, R3, !PT"),
        (None, "", "VOTE.ANY", "R1, PT, P1"),
        (None, "@!P1", "ATOMS.ADD", "R1, [UR4], R2"),
        ("first_done", "", "BAR.SYNC.DEFER_BLOCKING", "0x0"),
        (None, "@P1", "BRA", "@done"),
        ("listed", "", "IADD3", "R1, R1, 0x100, RZ"),
        *planes,
        (None, "@P2", "BRA", "@tests"),
        *[(None, "", "MUFU.RSQ", f"R{i}, R{i}") for i in range(2 * kb)],
        (None, "@P3", "BRA", "@tests"),
        (None, "", "STG.E", "desc[UR4][R2.64], R3"),
        (None, "", "BRA", "@next"),
        ("tests", "", "FMUL.SAT", "R0, R0, R0"),
        *[(None, "", "FMUL.SAT", f"R{i}, R{i}, R1") for i in range(1, 2 * kb * kb)],
        (None, "", "MUFU.RSQ", "R5, R6"),
        (None, "", "STG.E", "desc[UR4][R2.64], R5"),
        ("next", "@P4", "BRA", "@listed"),
        ("done", "", "EXIT", ""),
    ])


def test_polygon_distance_issue_floor_on_the_passes(monkeypatch):
    _patched(monkeypatch, _distance_sass(4))
    monkeypatch.setattr(cs, "_bucket", lambda k: 4)
    floor = cs.polygon_distance_issue_floor(None, 4, 4, 100, 10, 95)
    # first pass: BAR, BRA, 16 loads, FMNMX, VOTE, ATOMS, BAR
    assert floor["sass_first_pass"] == 22
    # separated in the first pass: IADD3, 16 loads, BRA, 32 FMUL.SAT, the
    # sqrt, STG, the back edge; overlapping: IADD3, 16 loads, BRA, 8 RSQ,
    # BRA, STG, BRA, the back edge; through both: the axes, then the tests
    assert (floor["sass_separated_early"], floor["sass_overlapping"]) == (53, 30)
    assert floor["sass_per_pair"] == 62
    # 10 undecided, 5 of them separated: 90 separated in the first pass, 5
    # overlapping, 5 through both
    evaluated = 100 * 22 + 90 * 53 + 5 * 30 + 5 * 62
    assert floor["sass_per_pair_evaluated"] == pytest.approx(evaluated / 100)
    assert floor["issue_floor_ms"] == pytest.approx(cs._issue_ms(100 * 62)[0])
    assert floor["issue_floor_ms_at_work_evaluated"] == pytest.approx(cs._issue_ms(evaluated)[0])


def test_polygon_distance_issue_floor_refuses_a_pass_it_cannot_read(monkeypatch):
    ins = [x for x in _distance_sass(4) if x[2] != "FMUL.SAT" or x[3] != "R0, R0, R0"]
    _patched(monkeypatch, ins)
    monkeypatch.setattr(cs, "_bucket", lambda k: 4)
    with pytest.raises(RuntimeError, match="FMUL.SAT"):
        cs.polygon_distance_issue_floor(None, 4, 4, 100, 10, 95)


# Kernels 6 and 10 above 16 vertices (csrc/polygon_big_k.cuh): a block loop
# of two axes (its set-up, a guarded vertex walk of two vertices an
# iteration folding 8 minima from 2 loads, the block's test), a remainder
# walk of one axis, and for kernel 10 an incident loop with its 1/|n|.
_BIG_K = """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDS R1, [R0] ;
        /*0020*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0030*/                   FADD R3, R3, R4 ;
        /*0040*/                   FADD R5, R5, R6 ;
        /*0050*/              @P0  BRA 0x100 ;
        /*0060*/                   LDS R7, [R0] ;
        /*0070*/                   LDS R8, [R0+0x200] ;
        /*0080*/                   FMUL R9, R7, R3 ;
        /*0090*/                   FMNMX R10, R10, R9, PT ;
        /*00a0*/                   FMNMX R11, R11, R9, !PT ;
        /*00b0*/                   FMNMX R12, R12, R8, PT ;
        /*00c0*/                   FMNMX R13, R13, R8, !PT ;
        /*00d0*/                   FMNMX R14, R14, R9, PT ;
        /*00e0*/                   FMNMX R15, R15, R9, !PT ;
        /*00f0*/                   FMNMX R16, R16, R8, PT ;
        /*00f8*/                   FMNMX R17, R17, R8, !PT ;
        /*00fc*/              @P1  BRA 0x60 ;
        /*0100*/                   FSETP.LT.OR P2, PT, R10, R11, P2 ;
        /*0110*/              @P3  BRA 0x20 ;
        /*0120*/                   LDS R18, [R0] ;
        /*0130*/                   FMNMX R19, R19, R18, PT ;
        /*0140*/              @P4  BRA 0x120 ;
        /*0150*/                   MUFU.RSQ R20, R21 ;
        /*0160*/                   FMUL R22, R20, R21 ;
        /*0170*/              @P5  BRA 0x150 ;
        /*0180*/                   EXIT ;
        /*0190*/                   BRA 0x190 ;
"""


def _big_k_patched(monkeypatch, names):
    _patched(monkeypatch, _ins(_BIG_K))
    monkeypatch.setattr(cs, "_sass_names", lambda lib: names)


def test_big_k_issue_floor_at_the_main_walk(monkeypatch):
    _big_k_patched(monkeypatch, ["_ZN3_GLOBAL_24polygon_sat_big_k_kernelIfLi128EEEv"])
    pairs, undecided = 10, 4
    floor = cs.big_k_issue_floor(None, "6", 4, 32, pairs, undecided)
    # the walk: 2 loads, the product, 8 minima and the back edge = 12 an
    # iteration for 4 projections (8 minima, 2 each): a block of 2 axes
    assert (floor["sass_walk_iteration"], floor["projections_per_iteration"]) == (12, 4)
    assert floor["block"] == 2
    # the block's set-up past the walk: IADD3, 2 FADD, the guard, the test,
    # the back edge
    assert floor["sass_block_setup"] == 6
    # 8 first-pass axes a pair, the 32 of the 32-gon for each undecided
    # pair (every edge of the 4-gon was in the first pass)
    axes = 8 * pairs + 32 * undecided
    assert cs.big_k_work("6", 4, 32, pairs, undecided) == (axes, 36 * axes)
    total = 12 / 4 * 36 * axes + 6 / 2 * axes
    assert floor["sass_per_pair"] == pytest.approx(total / pairs)
    assert floor["issue_floor_ms"] == pytest.approx(cs._issue_ms(total)[0])
    assert floor["sass_incident"] == 0


def test_big_k_issue_floor_counts_kernel_10s_incident_loop(monkeypatch):
    _big_k_patched(monkeypatch, ["_ZN3_GLOBAL_29polygon_manifold_big_k_kernelILi128EEEv"])
    floor = cs.big_k_issue_floor(None, "10", 4, 32, 10, 0)
    # one minimum a projection: 8 an iteration; a block of 4 faces
    assert (floor["projections_per_iteration"], floor["block"]) == (8, 4)
    assert floor["sass_incident"] == 3
    faces, projections = cs.big_k_work("10", 4, 32, 10, 0)
    assert (faces, projections) == (36 * 10, 2 * 4 * 32 * 10)
    total = 12 / 8 * projections + 6 / 4 * faces + 3 * 4 * 10
    assert floor["sass_per_pair"] == pytest.approx(total / 10)


def test_big_k_issue_floor_of_the_unrolled_design(monkeypatch):
    # a library of the earlier design: its bucket pair's function straight
    # through, the shortest path to the last exit (every branch either way)
    _big_k_patched(monkeypatch, ["_ZN3_GLOBAL_18polygon_sat_kernelILi4ELi32EfEEvPKT1_"])
    floor = cs.big_k_issue_floor(None, "6", 4, 20, 10, 3)
    assert floor["design"] == "unrolled" and floor["function"] == "polygon_sat_kernelILi4ELi32EfE"
    assert floor["sass_per_pair"] == cs._shortest_iteration(_ins(_BIG_K), 0, 0x180)[0]


# Kernel 9 above 16 vertices (csrc/polygon_big_k.cuh): the first pass's
# walk (no loop around it), a block loop of one axis (its set-up, a guarded
# walk folding 4 minima from 1 load, then the scaled gap's 1/|n| and max),
# and a block loop of one segment (its set-up, a guarded walk of 2 tests,
# then the minimum).
_BIG_K_DISTANCE = """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDS R1, [R0] ;
        /*0020*/                   FMNMX R2, R2, R1, PT ;
        /*0030*/                   FMNMX R3, R3, R1, !PT ;
        /*0040*/                   FMNMX R4, R4, R1, PT ;
        /*0050*/                   FMNMX R5, R5, R1, !PT ;
        /*0060*/              @P0  BRA 0x10 ;
        /*0070*/                   IADD3 R6, R6, 0x1, RZ ;
        /*0080*/                   FADD R7, R7, R8 ;
        /*0090*/              @P1  BRA 0x100 ;
        /*00a0*/                   LDS R9, [R0] ;
        /*00b0*/                   FMUL R10, R9, R7 ;
        /*00c0*/                   FMNMX R11, R11, R10, PT ;
        /*00d0*/                   FMNMX R12, R12, R10, !PT ;
        /*00e0*/                   FMNMX R13, R13, R10, PT ;
        /*00e8*/                   FMNMX R14, R14, R10, !PT ;
        /*00f0*/              @P2  BRA 0xa0 ;
        /*0100*/                   MUFU.RSQ R15, R16 ;
        /*0110*/                   FMNMX R17, R17, R15, !PT ;
        /*0120*/              @P3  BRA 0x70 ;
        /*0130*/                   FADD R18, R18, R19 ;
        /*0140*/                   MUFU.RCP R20, R18 ;
        /*0150*/              @P4  BRA 0x1c0 ;
        /*0160*/                   LDS R21, [R0] ;
        /*0170*/                   FMUL.SAT R22, R21, R20 ;
        /*0180*/                   FMUL.SAT R23, R21, R20 ;
        /*0190*/                   FMNMX R24, R24, R22, PT ;
        /*01a0*/                   FMNMX R25, R25, R23, PT ;
        /*01b0*/              @P5  BRA 0x160 ;
        /*01c0*/                   FMNMX R26, R24, R25, PT ;
        /*01d0*/              @P6  BRA 0x130 ;
        /*01e0*/                   EXIT ;
        /*01f0*/                   BRA 0x1f0 ;
"""


def test_big_k_issue_floor_of_kernel_9s_passes(monkeypatch):
    _patched(monkeypatch, _ins(_BIG_K_DISTANCE))
    monkeypatch.setattr(cs, "_sass_names", lambda lib: [
        "_ZN3_GLOBAL_29polygon_distance_big_k_kernelILi128EEEvPKfS2_Pfxiibbb"])
    pairs, undecided, separated = 10, 4, 7
    floor = cs.big_k_issue_floor(None, "9", 4, 32, pairs, undecided, separated)
    # the first pass's walk (no loop around it): LDS, 4 minima, the back
    # edge = 6 an iteration for 2 projections
    assert floor["sass_per_first_projection"] == 3
    # the axis walk (in a block loop): LDS, FMUL, 4 minima, the back edge =
    # 7 an iteration for 2 projections
    assert (floor["sass_walk_iteration"], floor["projections_per_iteration"]) == (7, 2)
    # the block's set-up skips the walk but keeps the gap's 1/|n| and max:
    # IADD3, FADD, the guard, MUFU.RSQ, FMNMX, the back edge
    assert (floor["sass_block_setup"], floor["block"]) == (6, 1)
    # the segment walk: LDS, 2 FMUL.SAT, 2 minima, the back edge = 6 for 2
    # tests; its block: FADD, MUFU.RCP, the guard, the minimum, the back edge
    assert (floor["sass_per_test"], floor["sass_segment_setup"], floor["segments"]) == (
        3, 5, 1)
    work = cs.big_k_distance_work(4, 32, pairs, undecided, separated)
    assert work == dict(first_projections=8 * 36 * 10, projections=36 * 36 * 4,
                        axes=36 * 4, segments=36 * 7, tests=2 * 4 * 32 * 7)
    total = (3 * work["first_projections"] + 7 / 2 * work["projections"] + 6 * work["axes"]
             + 3 * work["tests"] + 5 * work["segments"])
    assert floor["sass_per_pair"] == pytest.approx(total / pairs)
    assert floor["issue_floor_ms"] == pytest.approx(cs._issue_ms(total)[0])


def test_big_k_issue_floor_of_kernel_9s_unrolled_design(monkeypatch):
    # a library of the earlier design (its bucket pair's body unrolled):
    # `polygon_distance_issue_floor`'s pair through the first pass, every
    # axis and every test
    _patched(monkeypatch, _distance_sass(4))
    monkeypatch.setattr(cs, "_bucket", lambda k: 4)
    monkeypatch.setattr(cs, "_sass_names", lambda lib: [
        "_ZN3_GLOBAL_23polygon_distance_kernelILi4ELi4EEEvPKfS2_Pfxii"])
    floor = cs.big_k_issue_floor(None, "9", 4, 20, 100, 10, 95)
    assert floor["design"] == "unrolled"
    assert floor["function"] == "polygon_distance_kernelILi4ELi4EE"
    assert floor["sass_per_pair"] == 62
    assert floor["issue_floor_ms"] == pytest.approx(cs._issue_ms(100 * 62)[0])
