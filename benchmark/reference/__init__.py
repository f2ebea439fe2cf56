"""Plain f32 reference of what a cell's node computes: a frozen copy of
WordPiece, the BERT and MPNet forwards in plain torch, and an exact
top-k. It imports nothing of the port (tests/test_bench_imports.py)."""
