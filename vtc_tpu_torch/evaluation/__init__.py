"""Evaluation of the port: Recall@K on a transfer dataset
(``retrieval_eval.retrieval_evaluation``), and the twins of
``evaluation/eval.py`` and ``evaluation/retrieval_evaluation.py``
(``eval``, ``retrieval_evaluation``: the CLI modules). Nothing is
re-exported here: the CLI module ``retrieval_evaluation`` would shadow the
function of that name."""
