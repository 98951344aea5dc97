"""Training of the port: only ``model_stage_names`` so far (the trainer
is ROADMAP queue 1 item 6)."""
