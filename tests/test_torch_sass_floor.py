"""The SASS path search behind `chip_smoke.py`'s issue floors, on the CPU.

`chip_smoke._shortest_iteration` walks one iteration of a loop in the
kernel's SASS, each conditional forward branch either way, and gives the
fewest instructions a warp can issue for it. Kernel 11's floor asks for the
shortest path among those that divide most often (``most``): its early
exit's vote branches past the shape's later faces, and the floor is the
path through every face with the votes issued and not taken. Here both
searches run on a hand-written loop of that form.
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
