"""The serving engine: slots, tokenizer, chunked prefill, K-step decode."""
