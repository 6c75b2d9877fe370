"""core.rounds.solo: propose rounds a solve (Solution.rounds), the mean
over the solves of the window."""


def read(w):
    return sum(w.rounds) / len(w.rounds) if w.rounds else None
