"""Device memory a job leaves in Python's reference cycles, in MiB: what
the harness's collection after each job of the untraced window frees
(``torch.cuda.memory_allocated`` before it less after it), averaged over
the window's jobs. The harness collects so that ``peak_gib`` does not grow
with the number of jobs; a user's loop holds these bytes until Python's
own collector runs."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "MiB", "lower", "program_counter", "driver", "peak_gib"


def read(run):
    freed = [j["cycle_bytes"] for j in run.jobs if j.get("cycle_bytes") is not None]
    if not freed:
        return None
    return sum(freed) / len(freed) / 2**20
