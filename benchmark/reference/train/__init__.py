"""The plain reference of one training micro-step: the loss, autograd and
AdamW."""
