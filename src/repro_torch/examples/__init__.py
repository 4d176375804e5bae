"""Runnable workloads of the port, each ``python -m
repro_torch.examples.<name> [--device cpu]``:

- ``quickstart``: the paper's §2.3 logistic regression, from SQL
  (``Database.sql``) to 50 compiled gradient steps;
- ``nnmf``: non-negative matrix factorization (paper Appendix B, Fig. 2)
  over ``rel_matmul_blocked``;
- ``kge``: knowledge-graph embeddings, TransE-L2 and TransR (paper
  Appendix C, Fig. 3), over ``rel_embed``;
- ``gcn_train``: the two-layer GCN of the paper's §6 with Adam, full-graph
  or mini-batch;
- ``lm_train``: an OLMoE-family language model trained on the synthetic
  pipeline through ``train.make_train_step``, with checkpoints.

Each runs on the CUDA device unless ``--device`` names another.
"""
