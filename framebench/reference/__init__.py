"""The plain reference the check compares against."""
