"""A ``cuobjdump -sass`` listing written out by hand, for the CPU tests of
the SASS counters in ``tpu_pathtracer_torch/experiments`` (the dumps
themselves come from the card's toolkit only).

``listing(name, lines)``: one function ``name`` whose instructions are
``lines``, 16 bytes apart from address 0; a line ``"label:"`` names the
next instruction's address, and ``{label}`` in an instruction is replaced
by it, as ``BRA`` targets appear in a dump.
"""


def listing(name, lines):
    addr, labels, code = 0, {}, []
    for line in lines:
        if line.endswith(":"):
            labels[line[:-1]] = addr
        else:
            code.append((addr, line))
            addr += 16
    out = [f"\t\tFunction : {name}"]
    for a, ins in code:
        ins = ins.format(**{k: hex(v) for k, v in labels.items()})
        out.append(f"        /*{a:04x}*/                   {ins} ;"
                   f"                 /* 0x000000000000000000 */")
    return "\n".join(out) + "\n"
