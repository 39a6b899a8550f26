"""Training: optimizer, schedules and the train and eval steps."""
