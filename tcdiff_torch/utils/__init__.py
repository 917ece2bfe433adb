"""Run-time helpers of the trainers: logging, step timing and traces, run
directories and checkpoints."""
