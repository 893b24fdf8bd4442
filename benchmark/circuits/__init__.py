"""Circuit kinds, one module each, found by a configuration's ``circuit``.

Each module gives:

* ``setup_circuit(cfg)``: the circuit that setup synthesizes;
* ``draw_statement(cfg, rng)``: a statement (plain ints) from a
  ``random.Random``;
* ``prepare(cfg, statement)``: what the prover is handed for it (a
  witness computed here arrives precomputed, as a witness file does);
* ``prove_circuit(cfg, prepared)``: the circuit that ``prove`` synthesizes.

The reference computes a statement's public inputs on its own
(``ref/kinds/<kind>.py``).
"""
