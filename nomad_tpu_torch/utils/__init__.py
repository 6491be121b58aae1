"""Small self-contained libraries (own copies): the lock witness, the
delay and score heaps, metrics, fault points, the wave cohort tracker,
the time table and cron expressions."""
