"""Faults planted under the timed path, to show that the check catches
them: each takes the port's ``ServingEngine`` after set-up and breaks its
decode step (``harness.run_cell(tamper=...)``).  The faults a one-card
serving cell can have: a step that returns its state unchanged, half of
the batch left out, a token altered where it is produced.  (No exchange
between cards: every cell runs on one.)"""


def state_unchanged(eng):
    """Each decode step's writes to the slot cache are undone."""
    run = eng._run

    def step():
        saved = [t.clone() for g in eng.cache.values() for t in g.values()]
        out = run()
        for t, s in zip((t for g in eng.cache.values() for t in g.values()),
                        saved):
            t.copy_(s)
        return out
    eng._run = step


def half_left_out(eng):
    """The upper half of the slots is never computed: each keeps its
    previous token."""
    run = eng._run

    def step():
        nxt, ok = run()
        nxt = nxt.copy()
        half = eng.n_slots // 2
        nxt[half:] = eng.tok[half:]
        return nxt, ok
    eng._run = step


def token_altered(eng):
    """Every slot's next token is moved to its neighbour in the vocabulary
    where the step produces it."""
    run = eng._run

    def step():
        nxt, ok = run()
        return (nxt + 1) % eng.cfg.vocab, ok
    eng._run = step


ALL = (state_unchanged, half_left_out, token_altered)
