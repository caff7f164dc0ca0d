"""``vlsfr_tpu_torch/tools/wgmma_sass_check.py`` on SASS listings written
here in the form ``cuobjdump -sass`` prints (no card or toolkit needed):
the streamed conv's pattern (two A fragment sets by turns under
``wgmma_wait<1>``) passes, and the same chain reloading one fragment set
while its product is in flight is reported."""

import pytest

from vlsfr_tpu_torch.tools.wgmma_sass_check import check_sass

HEAD = "\t\tFunction : _Z6kernelv\n"


def _listing(a_regs, waits=1, tail_wait=True):
    lines, addr = [], 0

    def emit(text):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {text} ;   /* 0x0 */")
        addr += 16

    emit("SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR8], R2")
    for i, a in enumerate(a_regs):
        emit(f"LDSM.16.M88.4 R{a}, [R{a}+UR30]")
        emit("WARPGROUP.ARRIVE")
        acc = "RZ, !UPT" if i == 0 else "R24"
        emit(f"HGMMA.64x128x16.F32.BF16 R24, R{a}, gdesc[UR8].tnspB, {acc}, gsb0")
        emit(f"WARPGROUP.DEPBAR.LE gsb0, 0x{waits}")
    if tail_wait:
        emit("WARPGROUP.DEPBAR.LE gsb0, 0x0")
    emit("FADD R200, R24, R200")
    return HEAD + "\n".join(lines) + "\n"


@pytest.mark.parametrize("a_regs", [[88, 92] * 4 + [88], list(range(88, 124, 4))])
def test_distinct_or_alternating_fragments_pass(a_regs):
    (res,) = check_sass(_listing(a_regs)).values()
    assert res["products"] == len(a_regs) and res["max_in_flight"] == 2
    assert res["hazards"] == []


def test_one_fragment_set_reloaded_in_flight_is_reported():
    (res,) = check_sass(_listing([88] * 3)).values()
    assert len(res["hazards"]) == 2
    assert "over the A operand R88" in res["hazards"][0]


def test_accumulator_read_before_the_last_wait_is_reported():
    (res,) = check_sass(_listing([88, 92], tail_wait=False)).values()
    # FADD reads R24 (no write): no hazard; a write to the accumulator is one
    assert res["hazards"] == []
    bad = _listing([88, 92], tail_wait=False).replace("FADD R200, R24, R200",
                                                      "FADD R30, R24, R200")
    (res,) = check_sass(bad).values()
    assert any("accumulator R24" in h for h in res["hazards"])


def test_wait_zero_makes_one_fragment_set_safe():
    (res,) = check_sass(_listing([88] * 3, waits=0)).values()
    assert res["hazards"] == [] and res["max_in_flight"] == 1
