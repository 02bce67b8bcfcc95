"""Clean-exit signal handling (port of future_od_tpu/utils/signals.py).

SIGINT, SIGTERM and SIGUSR2 set the EXIT event; the Trainer polls it every
iteration and every epoch and returns cleanly, so the last checkpoint
survives preemption.
"""
from __future__ import annotations

import signal
import threading

EXIT = threading.Event()


def _clean_exit_handler(signum, frame):
    EXIT.set()
    print("Exiting cleanly", flush=True)


def install_signal_handlers():
    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGUSR2):
        try:
            signal.signal(sig, _clean_exit_handler)
        except (ValueError, OSError):
            pass  # not the main thread, or a signal the platform lacks
