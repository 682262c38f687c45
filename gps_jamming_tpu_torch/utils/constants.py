"""Physical and GNSS constants of the port (the same values as
gps_jamming_tpu.utils.constants; `tests/test_torch_selfcontained.py` holds
the two equal)."""

# Speed of light [m/s]
SPEED_OF_LIGHT = 299_792_458.0

# WGS-84 ellipsoid
WGS84_A = 6_378_137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E_SQ = WGS84_F * (2.0 - WGS84_F)

# Earth rotation rate [rad/s]
OMEGA_E_DOT = 7.2921151467e-5

# GPS constellation / L1 C/A signal
GPS_L1_FREQ_HZ = 1_575.42e6        # carrier
GPS_CA_CHIP_RATE_HZ = 1.023e6      # C/A chipping rate
GPS_CA_CODE_LEN = 1023             # chips per code period
GPS_CA_PERIOD_S = 1e-3             # one code period
GPS_NUM_PRN = 32
GPS_MU = 3.986005e14               # WGS-84 earth gravitational parameter
GPS_F_REL = -4.442807633e-10       # relativistic correction constant

# GLONASS G1 FDMA
GLO_G1_BASE_FREQ_HZ = 1_602.0e6
GLO_G1_CH_SPACING_HZ = 562_500.0   # k * 0.5625 MHz
GLO_CODE_LEN = 511
GLO_CHIP_RATE_HZ = 0.511e6
GLO_NUM_CH = 14

# Galileo E1B
GAL_E1_FREQ_HZ = 1_575.42e6
GAL_E1B_CODE_LEN = 4092
GAL_E1B_CHIP_RATE_HZ = 1.023e6
GAL_E1B_PERIOD_S = 4e-3
GAL_NUM_PRN = 36

# Default RTL-SDR capture parameters
DEFAULT_SAMPLE_RATE_GPS = 2_048_000.0
DEFAULT_SAMPLE_RATE_GLO = 10_000_000.0

# Geographic small-offset conversion
METERS_PER_DEGREE_LAT = 111_320.0
METERS_PER_DEGREE_LON = 111_320.0

# GPS time
GPS_WEEK_SECONDS = 604_800.0
GPS_HALF_WEEK_SECONDS = 302_400.0
