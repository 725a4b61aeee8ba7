"""Runtime guardrails of the serving stack (the JAX package's
``repro.analysis``): ``guards``, the steady-state guard.  The AST linter
waits for ROADMAP.md queue N, item N10b."""
