"""The controls of the comparison that decides `correct`."""
