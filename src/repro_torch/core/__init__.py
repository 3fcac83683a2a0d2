"""Simulator core: host-side event generation and the device-side updates."""
