"""The LM framework's models: layers, attention, blocks and model bundles."""
