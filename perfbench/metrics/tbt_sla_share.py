"""Share of the window's gaps between visible tokens within the cell's
TBT SLA (`--sla-ms`), in %."""
LAYER = "controller"
UNIT = "%"
MOVES = "tbt_p95_ms"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    flags = [str(a) for a in run.cell["serve"]]
    if "--sla-ms" not in flags:
        return None
    sla = float(flags[flags.index("--sla-ms") + 1])
    gaps = run.gaps_ms()
    if sla <= 0 or not gaps:
        return None
    return 100.0 * sum(g <= sla for g in gaps) / len(gaps)
