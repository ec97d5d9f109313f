"""One plain module a problem, found by the configuration's ``problem``:
``expand(A, masks, sols)`` (a dict of sets and per-row numbers, with
``in_mask``), ``infeasible(dense, size, words)``, and where a claimed
optimum is checked ``optimum(dense)``; a problem that the program solves on
another graph than the one it is given (the complement, say) adds
``adjacency(dense)``, the graph its expansion reads."""
