"""Entry points of the LM stack: ``serve`` (batched prefill + cache
decode) and ``serve_batched`` (the serving example)."""
