"""The dense merge scans' rows passed in full a hundred rows updated in
place, in %: ``merge_scan.row_rescans`` over ``merge_scan.row_updates`` in
BuildTopology's records, in the window's jobs that the profiler did not
cover. B5 and B6 count them (a row is passed in full when no column holds
its minimum any more, or when its near set has overflowed)."""


def read(ctx):
    rescans = updates = 0
    for j in ctx["jobs"]:
        for r in j["stages"]:
            if r["stage"].split(".", 1)[-1] != "build_topology":
                continue
            c = r.get("counts", {})
            rescans += c.get("merge_scan.row_rescans", 0)
            updates += c.get("merge_scan.row_updates", 0)
    return 100.0 * rescans / updates if updates else None
