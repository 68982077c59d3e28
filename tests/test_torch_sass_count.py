"""chip_smoke.py's SASS instruction count (the issue bound of K1/K2) on a
small hand-written nvdisasm -c -gi listing: parsing, the fewest-path
walk with its anchors, CALLs into subroutines, and the pipe class of
each opcode."""

import pytest

LISTING = """\
.text._Z6kernelv:
        //## File "/src/bucket_rounds.cu", line 10
        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0010*/               @P0 BRA `(.L_x_1) ;
        //## File "/src/bucket_rounds.cuh", line 200 inlined at "/src/bucket_rounds.cu", line 20
        /*0020*/                   DFMA R2, R2, R4, R6 ;
        /*0030*/                   DFMA R2, R2, R4, R6 ;
        /*0040*/                   BRA `(.L_x_2) ;
.L_x_1:
        //## File "/src/bucket_rounds.cuh", line 201 inlined at "/src/bucket_rounds.cu", line 20
        /*0050*/                   IMAD.WIDE.U32 R2, R3, R4, RZ ;
        /*0060*/                   CALL.REL.NOINC `(.L_x_9) ;
.L_x_2:
        //## File "/src/bucket_rounds.cu", line 30
        /*0070*/                   EXIT ;
.L_x_9:
        /*0080*/                   MUFU.RCP64H R5, R3 ;
        /*0090*/                   I2F.F64.S64 R6, R2 ;
        /*00a0*/                   RET.REL.NODEC R20 `(_Z6kernelv) ;
"""


@pytest.fixture(scope="module")
def kernel():
    import chip_smoke as cs

    funcs = cs.parse_sass(LISTING)
    assert list(funcs) == ["_Z6kernelv"]
    return cs, funcs["_Z6kernelv"]


def test_parse_sass_keeps_locations_and_labels(kernel):
    cs, fn = kernel
    assert len(fn["ins"]) == 11
    assert fn["labels"] == {".L_x_1": 5, ".L_x_2": 7, ".L_x_9": 8}
    assert fn["ins"][2][1] == {("bucket_rounds.cuh", 200), ("bucket_rounds.cu", 20)}
    assert fn["ins"][8][1] == fn["ins"][7][1] == {("bucket_rounds.cu", 30)}


def _in_branch(text, loc):
    return any(f == "bucket_rounds.cuh" and 200 <= ln <= 201 for f, ln in loc)


@pytest.mark.parametrize("anchors, want", [
    # the DFMA side (6 instructions) is shorter than the CALL side (7)
    ([], {"int": 1, "fp64": 2, "other": 3}),
    # a location holds to the next: the first BRA is not the branch's
    ([_in_branch], {"int": 1, "fp64": 2, "other": 3}),
    # a path pinned through the CALL counts its subroutine in full
    ([lambda t, loc: t.startswith("CALL")], {"int": 2, "other": 4, "slow": 2}),
    # anchors are met in order
    ([lambda t, loc: t.startswith("IMAD"), lambda t, loc: t.startswith("EXIT")],
     {"int": 2, "other": 4, "slow": 2}),
])
def test_lane_instructions_fewest_path(kernel, anchors, want):
    cs, fn = kernel
    assert dict(cs.lane_instructions(fn, anchors)) == want


def test_lane_instructions_none_without_a_path(kernel):
    cs, fn = kernel
    assert cs.lane_instructions(fn, [lambda t, loc: "STG" in t]) is None


@pytest.mark.parametrize("op, pipe", [
    ("IMAD.WIDE.U32", "int"), ("IADD3.X", "int"), ("LOP3.LUT", "int"), ("SHF.R.S64", "int"),
    ("ISETP.GE.U32.AND", "int"), ("SEL", "int"), ("DFMA.RM", "fp64"), ("DSETP.GEU.AND", "fp64"),
    ("I2F.F64.S64", "slow"), ("F2I.S64.TRUNC", "slow"), ("MUFU.RCP64H", "slow"),
    ("FLO.U32", "slow"), ("SHFL.IDX", "other"), ("I2FP.F32.S32", "other"), ("LDG.E.128", "other"),
    ("BAR.SYNC", "other"), ("MOV", "other"),
])
def test_pipe_class(op, pipe):
    import chip_smoke as cs

    assert cs._pipe(op) == pipe
