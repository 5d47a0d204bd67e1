"""Share of the window (%) in which execute_buckets' level loop waited for a
level's host assembly: the sum over levels of the level's seconds less its
engine seconds, over the window. One reader for level_wait.fit and
level_wait.repredict."""


def read(rec, name):
    wait = sum(b["seconds"] - b["engine_seconds"]
               for u in rec["units"] for b in u["buckets"])
    return 100.0 * wait / rec["window_s"]
