"""Runnable workloads of the port, each ``python -m
repro_torch.examples.<name> [--device cpu]``:

- ``quickstart``: the paper's §2.3 logistic regression, from SQL
  (``Database.sql``) to 50 compiled gradient steps;
- ``nnmf``: non-negative matrix factorization (paper Appendix B, Fig. 2)
  over ``rel_matmul_blocked``;
- ``kge``: knowledge-graph embeddings, TransE-L2 and TransR (paper
  Appendix C, Fig. 3), over ``rel_embed``.

Each runs on the CUDA device unless ``--device`` names another.
"""
