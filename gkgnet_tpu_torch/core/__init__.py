"""Training core: optimizer, schedules, train and eval steps."""
