"""Device-to-host reads in BuildTopology over the trees it built (its
``topology`` notes), in the window's jobs that the profiler did not cover.
The reads are the counts of its records: ``topology.readbacks`` (the
loop's, one a block's mapping pass and one a candidate tree's) and
``merge_scan.readbacks`` (one a level of each tree where the clade rows
are made from the scan's merge lists, the B6 and B7 paths)."""

READS = ("topology.readbacks", "merge_scan.readbacks")


def read(ctx):
    reads = builds = 0
    counted = False
    for j in ctx["jobs"]:
        for r in j["stages"]:
            if r["stage"].split(".", 1)[-1] != "build_topology":
                continue
            if "counts" in r:
                counted = True
                reads += sum(r["counts"].get(k, 0) for k in READS)
            builds += sum(n["tree_builds"] for n in r.get("topology", []))
    return reads / builds if counted and builds else None
