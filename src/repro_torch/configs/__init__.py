"""Registry mirrors (pinned equal to the reference by test)."""
