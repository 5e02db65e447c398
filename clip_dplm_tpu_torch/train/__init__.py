"""Train state, fused AdamW, schedules, the train/eval steps and the Trainer."""
