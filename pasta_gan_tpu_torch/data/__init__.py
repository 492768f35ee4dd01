"""Host samples, routing geometry and the device-side try-on batch."""
