"""A job's wall seconds outside its stage records (MakeChunks and the
reads, the pool's start and close around the stages), per thousand SNPs."""


def read(ctx):
    jobs = ctx["jobs"]
    snps = sum(j["snps"] for j in jobs)
    if not snps:
        return None
    s = sum(j["wall_s"] - sum(r["wall_s"] for r in j["stages"])
            for j in jobs)
    return s / snps * 1e3
