"""One module per driver kind, named by a traffic mix's ``driver``.  Each
has ``setup(cell, seed, device)``, ``window(state, seconds, trace)``,
``release(state)``, ``end_to_end(win)`` and ``check(cell, seed, device,
state, win)``; ``run.execute`` calls them in that order."""
