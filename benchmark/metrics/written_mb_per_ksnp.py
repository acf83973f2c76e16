"""MB the program's writers wrote (the ``bytes_written`` counts of the stage
records: Paint's checkpoints, the sections' and chunks' ``.anc``/``.mut``,
the final ``.anc``/``.mut``), per thousand SNPs of the window's jobs that
the profiler did not cover."""


def read(ctx):
    jobs = ctx["jobs"]
    snps = sum(j["snps"] for j in jobs)
    recs = [r for j in jobs for r in j["stages"] if "counts" in r]
    if not snps or not recs:
        return None
    b = sum(r["counts"].get("bytes_written", 0) for r in recs)
    return b / 1e6 / snps * 1e3
