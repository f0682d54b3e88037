"""The LM scaffold's serving path: parameter defs, layers, attention,
blocks and the model (``lm.forward``/``prefill``/``decode_step`` and the
``lm.LanguageModel`` module) for the attention families."""
