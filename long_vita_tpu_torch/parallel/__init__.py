"""Context and data parallelism for the port: communicators, the (dp, cp, tp)
mesh of ranks, the zigzag permutation and a rank's slice of a batch."""
