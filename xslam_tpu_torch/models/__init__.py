"""The SLAM engine."""
