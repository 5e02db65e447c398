"""ESM-2 tower, DPLM and the two-tower CLIP (torch.nn)."""
