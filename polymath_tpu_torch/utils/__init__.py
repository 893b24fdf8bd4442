"""Device selection and phase timers."""
