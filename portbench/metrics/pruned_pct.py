"""``pruned_pct.<technique>``: partitions the technique removed over those
it was given, summed over the stream's verified prefix (each report's
before and after, as ``TechniqueReport.ratio`` counts them)."""

from __future__ import annotations


def read(run, name: str):
    tech = name.split(".", 1)[1]
    before = after = 0
    for i in run.prefix:
        a = run.answers.get(i)
        if a is None:
            continue
        for techs in a["tech"].values():
            if tech in techs:
                before += techs[tech][0]
                after += techs[tech][1]
    return 100.0 * (before - after) / before if before else None
