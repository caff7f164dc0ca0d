"""Check a built kernel library's SASS for register-A ``wgmma`` hazards.

A ``wgmma.mma_async`` whose A operand comes from registers reads those
registers asynchronously: the PTX ISA leaves it undefined to write them
(or the accumulators) before a ``wgmma.wait_group`` has retired the group.
ptxas does not always keep such registers apart, so this tool reads what
it did: it walks each kernel's SASS (``cuobjdump -sass``) in address
order, opens a group at every register-A ``HGMMA`` (closed at ``gsb0``),
retires all but the newest N groups at every ``WARPGROUP.DEPBAR.LE gsb0,
N``, and reports every instruction that writes a register of an in-flight
group's A operand or accumulator. A branch is taken as falling through,
so a loop's back edge must retire its groups (a ``DEPBAR ... 0x0`` at the
end of the body), as the port's kernels do.

    python -m vlsfr_tpu_torch.tools.wgmma_sass_check [conv3x3 dot_probe]

builds the named ``csrc/*.cu`` sources (``ops/cuda_build.py``; needs
nvcc and ``cuobjdump``) and prints, per kernel with register-A products,
the products, their A registers, the most groups in flight and the
hazards; it exits non-zero on any hazard.
"""

from __future__ import annotations

import re
import subprocess
import sys

# instructions whose first operand is not a destination register
_NO_DEST = ("ST", "SYNCS", "BAR", "BRA", "EXIT", "RED", "ATOM", "WARPGROUP", "UTMA", "NOP",
            "DEPBAR", "RET", "CALL", "BSSY", "BSYNC", "UBLKCP", "MEMBAR", "FENCE", "ERRBAR",
            "CCTL", "ARRIVES", "USETMAXREG", "WARPSYNC", "BPT", "YIELD")
_INSN = re.compile(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;")


def _dest_width(op: str) -> int:
    """Registers an instruction writes from its destination."""
    if op.startswith("LDSM"):
        return int(op.rsplit(".", 1)[-1])
    if ".128" in op:
        return 4
    if ".64" in op:
        return 2
    return 1


def check_function(sass: str) -> dict:
    """One function's SASS → {'products', 'a_regs', 'max_in_flight', 'hazards'}."""
    groups: list[list[tuple]] = []
    pending: list[tuple] = []
    hazards, a_regs, products, max_in_flight = [], set(), 0, 0
    for line in sass.splitlines():
        m = _INSN.match(line)
        if not m:
            continue
        addr, ins = m.groups()
        if ins.startswith("@"):
            ins = ins.split(" ", 1)[1]
        op, _, rest = ins.partition(" ")
        args = [a.strip() for a in rest.split(",")]
        if op.startswith("HGMMA"):
            products += 1
            areg = int(args[1][1:]) if re.fullmatch(r"R\d+", args[1]) else None
            if areg is not None:
                a_regs.add(areg)
            pending.append((addr, areg, int(args[0][1:])))
            if "gsb0" in ins:
                groups.append(pending)
                pending = []
            max_in_flight = max(max_in_flight, len(groups))
            continue
        if op.startswith("WARPGROUP.DEPBAR"):
            n = int(args[-1], 16)
            groups = groups[len(groups) - n:] if n else []
            continue
        if op.startswith(_NO_DEST) or not args or not re.fullmatch(r"R\d+", args[0]):
            continue
        d, w = int(args[0][1:]), _dest_width(op)
        for g in groups + ([pending] if pending else []):
            for gaddr, areg, acc in g:
                if areg is not None and d < areg + 4 and areg < d + w:
                    hazards.append(f"{addr} {op} R{d} over the A operand R{areg} of the "
                                   f"HGMMA at {gaddr}")
                if d < acc + 64 and acc < d + w:
                    hazards.append(f"{addr} {op} R{d} over the accumulator R{acc} of the "
                                   f"HGMMA at {gaddr}")
    return {"products": products, "a_regs": sorted(a_regs), "max_in_flight": max_in_flight,
            "hazards": hazards}


def check_sass(sass: str) -> dict[str, dict]:
    """Every function of a ``cuobjdump -sass`` listing that runs a
    register-A product, by mangled name."""
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        res = check_function(body)
        if res["a_regs"]:
            out[name.strip()] = res
    return out


def check_library(path: str) -> dict[str, dict]:
    from vlsfr_tpu_torch.ops.cuda_build import find_nvcc

    cuobjdump = find_nvcc()[:-len("nvcc")] + "cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return check_sass(sass)


def main(argv=None) -> int:
    from vlsfr_tpu_torch.ops.cuda_build import build_all, library_path

    names = (argv if argv is not None else sys.argv[1:]) or ["conv3x3", "dot_probe"]
    build_all(names)
    bad = 0
    for name in names:
        for fn, res in check_library(str(library_path(name))).items():
            bad += len(res["hazards"])
            print(f"{name}: {fn[:110]}: {res['products']} HGMMA, A registers {res['a_regs']}, "
                  f"at most {res['max_in_flight']} groups in flight, "
                  f"{len(res['hazards'])} hazards")
            for h in res["hazards"][:10]:
                print("    " + h)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
