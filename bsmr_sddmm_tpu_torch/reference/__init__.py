"""Plain references of the port's models: plain torch, imported by
module (``reference.sparse_transformer``); this package imports
nothing."""
