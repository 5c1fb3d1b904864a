"""Entry points of the LM stack: ``serve`` (batched prefill + cache
decode), ``serve_batched`` (the serving example) and ``train`` (plain and
hierarchical AutoFLSat training)."""
