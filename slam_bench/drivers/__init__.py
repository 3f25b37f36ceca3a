"""The general drivers: each reads a traffic file and runs its loop."""
