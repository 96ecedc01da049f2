"""State estimators of the port (the fleet's SoA UKF)."""
