"""The paper's algorithm: objectives, local solver, filter, clock and loops."""
