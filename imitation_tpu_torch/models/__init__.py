"""Network building blocks, action distributions and policies."""
