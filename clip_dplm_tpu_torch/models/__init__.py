"""ESM-2 tower and DPLM (torch.nn)."""
