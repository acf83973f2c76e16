"""Merge scans run (trees built, reverted candidates included) per thousand
SNPs: the ``topology`` notes of the BuildTopology records."""


def read(ctx):
    jobs = ctx["jobs"]
    snps = sum(j["snps"] for j in jobs)
    if not snps:
        return None
    builds = sum(n["tree_builds"] for j in jobs for r in j["stages"]
                 for n in r.get("topology", []))
    return builds / snps * 1e3
