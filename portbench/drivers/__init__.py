"""One driver a traffic kind: set-up, the window, the check."""
