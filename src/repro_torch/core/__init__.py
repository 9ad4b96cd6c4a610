"""The sparse core: Feature Engine, IDMap, Blocks, exchange, Embedding Engine."""
