"""Host-side data path: graphs, Euler walks, vocab, tokenizer, collator,
loader and datasets (numpy copies of `graphgpt_tpu/data/`)."""
