"""LM building blocks of the port: layers, GQA/local attention, the
RG-LRU block and the LM assembly (`attn` and `rec` blocks)."""
